"""The GEMMs' launch plans as the port mirrors them in Python
(ops/flash_attention.py::gemm_plan): tile rows, stages, shared memory, grid
and threads for every projection of the ViT-B/32, ViT-B/16 and ViT-L/14
towers at the batches the encoder pads to, in int8 (a block a tile) and in
bf16 (persistent clusters of two blocks over tiles of 64-192 rows), and the
shapes they refuse. The C side answers the same
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
# bf16, on a card that holds 66 clusters of two blocks (132 SMs): (tower,
# batch) -> per projection (tile rows, blocks launched, waves of cluster
# tiles). The tile height, 64, 128 or 192 rows, minimises waves x (G + 4)
# for G = rows / 64.
BF16_PLANS = {
    ("b32-vision", 4): ((64, 72, 1), (64, 24, 1), (64, 96, 1), (64, 24, 1)),
    ("b32-vision", 8): ((64, 126, 1), (64, 42, 1), (128, 96, 1), (64, 42, 1)),
    ("b32-vision", 64): ((192, 132, 3), (192, 102, 1), (192, 132, 4), (192, 102, 1)),
    ("b32-vision", 128): ((192, 132, 5), (192, 132, 2), (192, 132, 7), (192, 132, 2)),
    ("b32-vision", 256): ((192, 132, 10), (192, 132, 4), (192, 132, 13), (192, 132, 4)),
    ("b32-text", 4): ((64, 60, 1), (64, 20, 1), (64, 80, 1), (64, 20, 1)),
    ("b32-text", 8): ((64, 120, 1), (64, 40, 1), (128, 80, 1), (64, 40, 1)),
    ("b32-text", 64): ((192, 132, 3), (192, 104, 1), (192, 132, 4), (192, 104, 1)),
    ("b32-text", 128): ((192, 132, 5), (192, 132, 2), (192, 132, 7), (192, 132, 2)),
    ("b32-text", 256): ((192, 132, 10), (192, 132, 4), (192, 132, 13), (192, 132, 4)),
    ("b16-vision", 4): ((128, 126, 1), (64, 78, 1), (192, 120, 1), (64, 78, 1)),
    ("b16-vision", 8): ((128, 132, 2), (128, 78, 1), (192, 132, 2), (128, 78, 1)),
    ("b16-vision", 64): ((192, 132, 9), (192, 132, 3), (192, 132, 12), (192, 132, 3)),
    ("b16-vision", 128): ((192, 132, 18), (192, 132, 6), (192, 132, 24), (192, 132, 6)),
    ("b16-vision", 256): ((192, 132, 36), (192, 132, 12), (192, 132, 48), (192, 132, 12)),
    ("b16-text", 4): ((64, 60, 1), (64, 20, 1), (64, 80, 1), (64, 20, 1)),
    ("b16-text", 8): ((64, 120, 1), (64, 40, 1), (128, 80, 1), (64, 40, 1)),
    ("b16-text", 64): ((192, 132, 3), (192, 104, 1), (192, 132, 4), (192, 104, 1)),
    ("b16-text", 128): ((192, 132, 5), (192, 132, 2), (192, 132, 7), (192, 132, 2)),
    ("b16-text", 256): ((192, 132, 10), (192, 132, 4), (192, 132, 13), (192, 132, 4)),
    ("l14-vision", 4): ((128, 132, 2), (128, 72, 1), (192, 132, 2), (128, 72, 1)),
    ("l14-vision", 8): ((192, 132, 2), (192, 88, 1), (192, 132, 3), (192, 88, 1)),
    ("l14-vision", 64): ((192, 132, 16), (192, 132, 6), (192, 132, 21), (192, 132, 6)),
    ("l14-vision", 128): ((192, 132, 32), (192, 132, 11), (192, 132, 42), (192, 132, 11)),
    ("l14-vision", 256): ((192, 132, 63), (192, 132, 21), (192, 132, 84), (192, 132, 21)),
    ("l14-text", 4): ((64, 90, 1), (64, 30, 1), (64, 120, 1), (64, 30, 1)),
    ("l14-text", 8): ((128, 90, 1), (64, 60, 1), (128, 120, 1), (64, 60, 1)),
    ("l14-text", 64): ((192, 132, 4), (128, 132, 2), (192, 132, 5), (128, 132, 2)),
    ("l14-text", 128): ((192, 132, 8), (192, 132, 3), (192, 132, 10), (192, 132, 3)),
    ("l14-text", 256): ((192, 132, 15), (192, 132, 5), (192, 132, 19), (192, 132, 5)),
}
# bf16 tile rows -> (stages, shared memory bytes, threads): one consumer
# warpgroup per 64 rows and a producer warp; as many
# stages of (rows + 128) rows of 128 bytes as fit in 227 KB beside a 16 KB
# output slab per warpgroup (at most 8), 1024 bytes of alignment slack
BF16_BLOCK = {192: (4, 4 * 320 * 128 + 49152 + 1024, 416),
              128: (6, 6 * 256 * 128 + 32768 + 1024, 288),
              64: (8, 8 * 192 * 128 + 16384 + 1024, 160)}
# tile rows -> (stages, shared memory bytes, threads): four (256 rows),
# three (128) or four (64) stages of (rows + 128) rows of 128 bytes and 1024
# bytes of alignment slack; one warpgroup per 64 rows and a producer warp
BLOCK = {256: (4, 4 * 384 * 128 + 1024, 544), 128: (3, 3 * 256 * 128 + 1024, 288),
         64: (4, 4 * 192 * 128 + 1024, 160)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("tower,batch", list(PLANS))
def test_plan_of_every_tower_projection(tower, batch, dtype):
    t, w = TOWERS[tower]
    if dtype == torch.bfloat16:
        for gemm, (rows, blocks, waves) in zip(GEMMS, BF16_PLANS[(tower, batch)]):
            plan = fa.gemm_plan(*gemm_shape(gemm, batch * t, w), dtype)
            stages, smem, threads = BF16_BLOCK[rows]
            assert plan.refused is None, gemm
            assert (plan.rows, plan.stages, plan.smem_bytes, plan.grid, plan.threads,
                    plan.cluster, plan.waves) == \
                (rows, stages, smem, (blocks, 1), threads, 2, waves), gemm
        return
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


@pytest.mark.parametrize("rows", [64, 128, 192])
def test_bf16_blocks_fit_an_sm(rows):
    """One bf16 block an SM: its shared memory (and 16 bytes of barriers a
    stage) within the 227 KB a block may take, and the registers a consumer
    thread needs within the SM's 65,536 / threads: 64 accumulators and the
    epilogue take 100-110 (ptxas), which the 120 a thread of four
    warpgroups (256 rows) would not leave without spilling."""
    stages, smem, threads = BF16_BLOCK[rows]
    assert smem + 16 * stages <= 232448
    assert min(255, 65536 // threads // 8 * 8) >= 112


def _bf16_shapes():
    for tower, (t, w) in TOWERS.items():
        for batch in (4, 8, 64, 128, 256):
            for gemm in GEMMS:
                yield (tower, batch, gemm), gemm_shape(gemm, batch * t, w)


@pytest.mark.parametrize("clusters", [66, 65, 60])
def test_bf16_tiles_cover_the_output_on_whole_clusters(clusters):
    """Every projection of the three towers at batches 4-256: the tiles
    cover the output (column tiles of 128, row bands of the plan's height),
    the grid is a whole number of clusters of two, no more clusters than the
    card holds at once and none without a tile, and each cluster walks at
    most `waves` cluster tiles (a row band by a pair of column tiles)."""
    for case, (m, n, k) in _bf16_shapes():
        plan = fa.gemm_plan(m, n, k, torch.bfloat16, clusters)
        (cols, bands), (blocks, gy) = plan.tiles, plan.grid
        tiles = bands * -(-cols // 2)
        assert cols * 128 >= n > (cols - 1) * 128, case
        assert bands * plan.rows >= m > (bands - 1) * plan.rows, case
        assert plan.cluster == 2 and blocks % 2 == 0 and gy == 1, case
        assert blocks // 2 == min(clusters, tiles), case
        assert plan.waves == -(-tiles // clusters), case


def test_bf16_tile_height_is_the_cheapest_and_the_idle_share_bounded():
    """The plan's tile height costs no more waves x (G + 4) than any other of
    64, 128 and 192 rows (the L2 bytes of a block's K step: half of its A
    tile and all of its B tile, G = rows / 64), and where a shape has at
    least a wave of cluster tiles, at most 30 % of the launch's cluster slots
    (waves x clusters) are left without a tile (the worst is 27.3 %)."""
    def cost(m, n, g, clusters=66):
        tiles = -(-m // (64 * g)) * -(-(-(-n // 128)) // 2)
        return -(-tiles // clusters) * (g + 4), tiles

    for case, (m, n, k) in _bf16_shapes():
        plan = fa.gemm_plan(m, n, k, torch.bfloat16)
        chosen, tiles = cost(m, n, plan.rows // 64)
        assert all(chosen <= cost(m, n, g)[0] for g in (1, 2, 3)), case
        if tiles >= 66:
            assert 1 - tiles / (plan.waves * 66) <= 0.30, case


def test_the_bf16_plan_at_the_shapes_it_was_cut_for():
    """The three shapes whose last wave the tile plan was cut for: the B/32
    out-projection and fc2 at B = 256 take 192-row tiles (201 cluster tiles
    in 4 waves, cost 28, against 300 of 128 rows in 5, cost 30), the
    trainer's out-projection at B = 128 takes 192 rows (102 cluster tiles in
    2 waves), and the L/14 text batch at M = 4,928 takes 128 rows (117
    cluster tiles in 2 waves, cost 12, against 78 of 192 rows, also 2, cost
    14)."""
    for m, n, rows, waves in ((12800, 768, 192, 4), (6400, 768, 192, 2), (4928, 768, 128, 2)):
        plan = fa.gemm_plan(m, n, n, torch.bfloat16)
        assert (plan.rows, plan.waves) == (rows, waves), (m, n)


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
    # bf16: the tallest tile, 192 rows
    assert fa.gemm_plan(65535 * 64 + 1, 64, 64, torch.bfloat16).rows == 192


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
