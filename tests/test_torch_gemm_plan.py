"""The GEMM's launch plan as the port mirrors it in Python
(ops/flash_attention.py::gemm_plan): tile rows, stages, shared memory, grid
and threads for every projection of the ViT-B/32, ViT-B/16 and ViT-L/14
towers at the batches the encoder pads to, in bf16 and int8, and the shapes
it refuses. The C side answers the same
(tests/test_torch_gpu.py::test_gemm_plan_matches_the_kernels)."""

import pytest
import torch

from image_retrieval_tpu_torch.ops import flash_attention as fa

# (tokens per sequence, width) of each tower; hidden = 4 width
TOWERS = {"b32-vision": (50, 768), "b32-text": (77, 512), "b16-vision": (197, 768),
          "b16-text": (77, 512), "l14-vision": (257, 1024), "l14-text": (77, 768)}
GEMMS = ("qkv", "out", "fc1", "fc2")


def gemm_shape(gemm: str, m: int, w: int):
    """(m, n, k) of one projection of a layer of width w over m token rows."""
    return {"qkv": (m, 3 * w, w), "out": (m, w, w), "fc1": (m, 4 * w, w),
            "fc2": (m, w, 4 * w)}[gemm]


# (tower, batch) -> per projection (qkv, out, fc1, fc2): (tile rows, column
# tiles, row tiles). 256-row tiles where they give at least 132 blocks, else
# 128-row tiles where those do, else 64; column tiles of 128 (a last one of
# 64 where N % 128 = 64).
PLANS = {
    ("b32-vision", 4): ((64, 18, 4), (64, 6, 4), (64, 24, 4), (64, 6, 4)),
    ("b32-vision", 8): ((64, 18, 7), (64, 6, 7), (64, 24, 7), (64, 6, 7)),
    ("b32-vision", 64): ((256, 18, 13), (128, 6, 25), (256, 24, 13), (128, 6, 25)),
    ("b32-vision", 128): ((256, 18, 25), (256, 6, 25), (256, 24, 25), (256, 6, 25)),
    ("b32-vision", 256): ((256, 18, 50), (256, 6, 50), (256, 24, 50), (256, 6, 50)),
    ("b32-text", 4): ((64, 12, 5), (64, 4, 5), (64, 16, 5), (64, 4, 5)),
    ("b32-text", 8): ((64, 12, 10), (64, 4, 10), (64, 16, 10), (64, 4, 10)),
    ("b32-text", 64): ((256, 12, 20), (128, 4, 39), (256, 16, 20), (128, 4, 39)),
    ("b32-text", 128): ((256, 12, 39), (256, 4, 39), (256, 16, 39), (256, 4, 39)),
    ("b32-text", 256): ((256, 12, 77), (256, 4, 77), (256, 16, 77), (256, 4, 77)),
    ("b16-vision", 4): ((64, 18, 13), (64, 6, 13), (128, 24, 7), (64, 6, 13)),
    ("b16-vision", 8): ((128, 18, 13), (64, 6, 25), (256, 24, 7), (64, 6, 25)),
    ("b16-vision", 64): ((256, 18, 50), (256, 6, 50), (256, 24, 50), (256, 6, 50)),
    ("b16-vision", 128): ((256, 18, 99), (256, 6, 99), (256, 24, 99), (256, 6, 99)),
    ("b16-vision", 256): ((256, 18, 197), (256, 6, 197), (256, 24, 197), (256, 6, 197)),
    ("b16-text", 4): ((64, 12, 5), (64, 4, 5), (64, 16, 5), (64, 4, 5)),
    ("b16-text", 8): ((64, 12, 10), (64, 4, 10), (64, 16, 10), (64, 4, 10)),
    ("b16-text", 64): ((256, 12, 20), (128, 4, 39), (256, 16, 20), (128, 4, 39)),
    ("b16-text", 128): ((256, 12, 39), (256, 4, 39), (256, 16, 39), (256, 4, 39)),
    ("b16-text", 256): ((256, 12, 77), (256, 4, 77), (256, 16, 77), (256, 4, 77)),
    ("l14-vision", 4): ((128, 24, 9), (64, 8, 17), (256, 32, 5), (64, 8, 17)),
    ("l14-vision", 8): ((256, 24, 9), (128, 8, 17), (256, 32, 9), (128, 8, 17)),
    ("l14-vision", 64): ((256, 24, 65), (256, 8, 65), (256, 32, 65), (256, 8, 65)),
    ("l14-vision", 128): ((256, 24, 129), (256, 8, 129), (256, 32, 129), (256, 8, 129)),
    ("l14-vision", 256): ((256, 24, 257), (256, 8, 257), (256, 32, 257), (256, 8, 257)),
    ("l14-text", 4): ((64, 18, 5), (64, 6, 5), (64, 24, 5), (64, 6, 5)),
    ("l14-text", 8): ((64, 18, 10), (64, 6, 10), (64, 24, 10), (64, 6, 10)),
    ("l14-text", 64): ((256, 18, 20), (128, 6, 39), (256, 24, 20), (128, 6, 39)),
    ("l14-text", 128): ((256, 18, 39), (256, 6, 39), (256, 24, 39), (256, 6, 39)),
    ("l14-text", 256): ((256, 18, 77), (256, 6, 77), (256, 24, 77), (256, 6, 77)),
}
# tile rows -> (stages, shared memory bytes, threads): four (256 rows),
# three (128) or four (64) stages of (rows + 128) rows of 128 bytes and 1024
# bytes of alignment slack; one warpgroup per 64 rows and a producer warp
BLOCK = {256: (4, 4 * 384 * 128 + 1024, 544), 128: (3, 3 * 256 * 128 + 1024, 288),
         64: (4, 4 * 192 * 128 + 1024, 160)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("tower,batch", list(PLANS))
def test_plan_of_every_tower_projection(tower, batch, dtype):
    t, w = TOWERS[tower]
    for gemm, (rows, gx, gy) in zip(GEMMS, PLANS[(tower, batch)]):
        plan = fa.gemm_plan(*gemm_shape(gemm, batch * t, w), dtype)
        stages, smem, threads = BLOCK[rows]
        assert plan.refused is None, gemm
        assert (plan.rows, plan.stages, plan.smem_bytes, plan.grid, plan.threads) == \
            (rows, stages, smem, (gx, gy), threads), gemm


@pytest.mark.parametrize("rows", [64, 128, 256])
def test_blocks_fit_an_sm(rows):
    """Two blocks of 64 or 128 rows, one of 256, fit the SM's 228 KB of shared
    memory (each also takes 64 bytes of barriers and reserves 1 KB; a block
    may take 227 KB) and its 65,536 registers at the 112 (two blocks) or 120
    (one) a thread that __launch_bounds__ leaves."""
    _, smem, threads = BLOCK[rows]
    blocks, regs = (1, 120) if rows == 256 else (2, 112)
    assert smem <= 232448 and blocks * (smem + 64 + 1024) <= 228 * 1024
    assert blocks * threads * regs <= 65536


@pytest.mark.parametrize("m,n,k", [(1, 64, 64), (63, 192, 192), (65, 4096, 4096),
                                   (4928, 64, 1024), (400, 3072, 768)])
def test_the_plan_covers_the_output_and_fills_the_card(m, n, k):
    plan = fa.gemm_plan(m, n, k, torch.int8)
    gx, gy = plan.grid
    assert gx * 128 >= n > (gx - 1) * 128 and gy * plan.rows >= m > (gy - 1) * plan.rows
    # the largest tiles that give the card's 132 SMs a block each
    assert plan.rows == next((r for r in (256, 128) if -(-m // r) * gx >= 132), 64)


@pytest.mark.parametrize("m,n,k,why", [
    (0, 64, 64, "at least one row"),
    (8, 96, 64, "multiples of 64"),
    (8, 64, 100, "multiples of 64"),
    (8, 0, 64, "multiples of 64"),
    (8, 64, 0, "multiples of 64"),
    (8, 32, 32, "multiples of 64"),
    (65535 * 256 + 1, 64, 64, "65535 row tiles"),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_refused_shapes_say_why(m, n, k, why, dtype):
    plan = fa.gemm_plan(m, n, k, dtype)
    assert plan.refused is not None and why in plan.refused
    assert plan.rows == 0 and plan.grid == (0, 0)


def test_the_largest_m_takes_256_row_tiles():
    assert fa.gemm_plan(65535 * 256, 64, 64, torch.int8).grid == (1, 65535)
    assert fa.gemm_plan(65535 * 64 + 1, 64, 64, torch.bfloat16).rows == 256


def test_other_operand_types_are_refused():
    for dtype in (torch.float32, torch.float16, torch.uint8):
        with pytest.raises(TypeError, match="bfloat16 or int8"):
            fa.gemm_plan(8, 64, 64, dtype)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors gemm_bf16 and gemm_s8 are their plain versions and
    launch nothing."""
    g = torch.Generator().manual_seed(0)
    a8 = torch.randint(-127, 128, (5, 128), generator=g, dtype=torch.int8)
    b8 = torch.randint(-127, 128, (64, 128), generator=g, dtype=torch.int8)
    rs, cs, bias = torch.rand(5, generator=g), torch.rand(64, generator=g), torch.rand(64)
    before = fa.gemm_s8.launches, fa.gemm_bf16.launches
    for epilogue, r in (("bias", None), ("gelu", None), ("residual", torch.ones(5, 64))):
        got = fa.gemm_s8(a8, b8, rs, cs, bias, torch.float32, epilogue, r)
        assert torch.equal(got, fa.gemm_s8_reference(a8, b8, rs, cs, bias, torch.float32,
                                                     epilogue, r))
    a, bt = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
    v = a.float() @ bt.float().t() + bias
    assert torch.equal(fa.gemm_bf16(a, bt, bias), v.to(torch.bfloat16))
    assert (fa.gemm_s8.launches, fa.gemm_bf16.launches) == before


def test_the_int8_plain_gelu_is_quick_gelu():
    v = torch.linspace(-8, 8, 1001)
    assert torch.allclose(fa._gelu_f32(v), fa.quick_gelu(v), rtol=1e-6, atol=1e-7)
