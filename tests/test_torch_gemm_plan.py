"""The GEMM's launch plan as the port mirrors it in Python
(ops/flash_attention.py::gemm_plan): tile rows, stages, shared memory, grid
and threads for every projection of the ViT-B/32, ViT-B/16 and ViT-L/14
towers at the batches the encoder pads to, in int8 and in bf16 (one
persistent kernel: as many blocks as the card holds walking tiles of 64-192
rows, each block loading its own operand tiles), and the shapes it refuses.
The C side answers the same
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


# bf16 and int8 alike, on a card that holds 132 blocks at once (one an SM):
# (tower, batch) -> per projection (qkv, out, fc1, fc2): (tile rows, blocks
# launched, waves of tiles). The tile height, 64, 128 or 192 rows, minimises
# waves x (G + 2) for G = rows / 64.
PLANS = {
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
# tile rows -> (stages, shared memory bytes, threads), bf16 and int8: one
# consumer warpgroup per 64 rows and a producer warp; a 16 KB bf16 output
# slab and the tile's column parameters per warpgroup (bf16 the bias, 512
# bytes; int8 the column scales too, 1 KB) and 1024 bytes of alignment
# slack; as many stages of (rows + 128) rows of 128 bytes as fit beside them
# in 227 KB less 256 bytes for the static barriers (at most 8)
BF16_BLOCK = {192: (4, 4 * 320 * 128 + 3 * (16384 + 512) + 1024, 416),
              128: (6, 6 * 256 * 128 + 2 * (16384 + 512) + 1024, 288),
              64: (8, 8 * 192 * 128 + (16384 + 512) + 1024, 160)}
BLOCK = {192: (4, 4 * 320 * 128 + 3 * (16384 + 1024) + 1024, 416),
         128: (5, 5 * 256 * 128 + 2 * (16384 + 1024) + 1024, 288),
         64: (8, 8 * 192 * 128 + (16384 + 1024) + 1024, 160)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("tower,batch", list(PLANS))
def test_plan_of_every_tower_projection(tower, batch, dtype):
    t, w = TOWERS[tower]
    blocks_of = BF16_BLOCK if dtype == torch.bfloat16 else BLOCK
    for gemm, (rows, blocks, waves) in zip(GEMMS, PLANS[(tower, batch)]):
        m, n, k = gemm_shape(gemm, batch * t, w)
        plan = fa.gemm_plan(m, n, k, dtype)
        stages, smem, threads = blocks_of[rows]
        assert plan.refused is None, gemm
        assert (plan.rows, plan.stages, plan.smem_bytes, plan.grid, plan.threads,
                plan.waves) == (rows, stages, smem, (blocks, 1), threads, waves), gemm
        assert plan.tiles == (-(-n // 128), -(-m // rows)), gemm


@pytest.mark.parametrize("rows", [64, 128, 192])
def test_blocks_fit_an_sm(rows):
    """One int8 block an SM: its shared memory, 16 bytes of barriers a stage
    and 8 a warpgroup within the 227 KB a block may take, at least four
    stages, and the registers a consumer thread needs within what one SM
    sub-partition (16,384 registers) leaves each of the block's warps it
    holds: 64 int32 sums, two row scales and the epilogue take 101-116
    (ptxas), within the 128 of a 192-row block (13 warps, four on one
    sub-partition). 256-row tiles (17 warps, five) leave 96, and spilled."""
    stages, smem, threads = BLOCK[rows]
    assert smem + 16 * stages + 8 * (rows // 64) <= 232448 and stages >= 4
    warps = threads // 32
    assert min(255, 16384 // (-(-warps // 4) * 32) // 8 * 8) >= 120
    assert fa.gemm_block(rows // 64, 2) == (stages, smem, threads)


@pytest.mark.parametrize("rows", [64, 128, 192])
def test_bf16_blocks_fit_an_sm(rows):
    """One bf16 block an SM: its shared memory (and 16 bytes of barriers a
    stage, 8 a warpgroup) within the 227 KB a block may take, and the
    registers a consumer thread needs within the SM's 65,536 / threads: 64
    accumulators and the epilogue take 100-110 (ptxas), which the 120 a
    thread of four warpgroups (256 rows) would not leave without spilling."""
    stages, smem, threads = BF16_BLOCK[rows]
    assert smem + 16 * stages + 8 * (rows // 64) <= 232448
    assert min(255, 65536 // threads // 8 * 8) >= 112


@pytest.mark.parametrize("groups", [1, 2, 3, 4])
@pytest.mark.parametrize("params", [1, 2])
def test_every_block_form_fits_227_kb(groups, params):
    """Every form the kernel is built in (the variants files take 256-row
    bf16 tiles too): the ring, one output slab and the column parameters a
    warpgroup and the alignment slack within 227 KB less the static
    barriers' 256 bytes, with no room left for another stage or at the cap
    of 8."""
    stages, smem, threads = fa.gemm_block(groups, params)
    stage = (64 * groups + 128) * 128
    assert smem <= 232448 - 256 and threads == 128 * groups + 32
    assert stages == 8 or smem + stage > 232448 - 256
    assert smem == stages * stage + groups * (16384 + 512 * params) + 1024


def _tower_shapes():
    for tower, (t, w) in TOWERS.items():
        for batch in (4, 8, 64, 128, 256):
            for gemm in GEMMS:
                yield (tower, batch, gemm), gemm_shape(gemm, batch * t, w)


@pytest.mark.parametrize("blocks", [132, 130, 120])
def test_bf16_tiles_cover_the_output_on_whole_clusters(blocks):
    """Every projection of the three towers at batches 4-256: the tiles
    cover the output (column tiles of 128, row bands of the plan's height),
    the grid is no more blocks than the card holds at once and none without
    a tile, and each block walks at most `waves` tiles."""
    _tiles_cover_the_output(torch.bfloat16, blocks)


@pytest.mark.parametrize("blocks", [132, 130, 120])
def test_s8_tiles_cover_the_output_on_whole_clusters(blocks):
    """The same for the int8 plan, which takes the same tiles."""
    _tiles_cover_the_output(torch.int8, blocks)


def _tiles_cover_the_output(dtype, blocks):
    for case, (m, n, k) in _tower_shapes():
        plan = fa.gemm_plan(m, n, k, dtype, blocks)
        (cols, bands), (launched, gy) = plan.tiles, plan.grid
        assert cols * 128 >= n > (cols - 1) * 128, case
        assert bands * plan.rows >= m > (bands - 1) * plan.rows, case
        assert gy == 1, case
        assert launched == min(blocks, bands * cols), case
        assert plan.waves == -(-(bands * cols) // blocks), case


def _cost(m, n, g, blocks=132):
    """waves x (G + 2) of tiles of 64 G rows, and the tiles."""
    tiles = -(-m // (64 * g)) * -(-n // 128)
    return -(-tiles // blocks) * (g + 2), tiles


def _height_is_the_cheapest(dtype, groups):
    for case, (m, n, k) in _tower_shapes():
        plan = fa.gemm_plan(m, n, k, dtype)
        chosen, tiles = _cost(m, n, plan.rows // 64)
        assert plan.rows // 64 in groups, case
        assert all(chosen <= _cost(m, n, g)[0] for g in groups), case
        if tiles >= 132:
            assert 1 - tiles / (plan.waves * 132) <= 0.30, case


def test_bf16_tile_height_is_the_cheapest_and_the_idle_share_bounded():
    """The plan's tile height costs no more waves x (G + 2) than any other of
    64, 128 and 192 rows (the L2 bytes of a block's K step: its A tile and
    its B tile, G = rows / 64), and where a shape has at least a wave of
    tiles, at most 30 % of the launch's block slots (waves x blocks) are left
    without a tile (the worst is 27.3 %)."""
    _height_is_the_cheapest(torch.bfloat16, (1, 2, 3))


def test_s8_tile_height_is_the_cheapest_and_the_idle_share_bounded():
    """The same for int8: 256-row tiles, which would cost less at some
    shapes by this count, ran slower than 192-row ones (their 17 warps spill
    at 96 registers) and are not taken."""
    _height_is_the_cheapest(torch.int8, (1, 2, 3))
    assert any(_cost(m, n, 4)[0] < _cost(m, n, fa.gemm_plan(m, n, k, torch.int8).rows // 64)[0]
               for _, (m, n, k) in _tower_shapes())


def test_the_bf16_plan_at_the_shapes_it_was_cut_for():
    """The three shapes whose last wave the tile plan was cut for: the B/32
    out-projection and fc2 at B = 256 take 192-row tiles (402 tiles in 4
    waves, cost 20, against 600 of 128 rows in 5, also 20: ties go to the
    taller tile), the trainer's out-projection at B = 128 takes 192 rows (204
    tiles in 2 waves), and the L/14 text batch at M = 4,928 takes 128 rows
    (234 tiles in 2 waves, cost 8, against 156 of 192 rows, also 2, cost
    10)."""
    for m, n, rows, waves in ((12800, 768, 192, 4), (6400, 768, 192, 2), (4928, 768, 128, 2)):
        plan = fa.gemm_plan(m, n, n, torch.bfloat16)
        assert (plan.rows, plan.waves) == (rows, waves), (m, n)


@pytest.mark.parametrize("m,n,k", [(1, 64, 64), (63, 192, 192), (65, 4096, 4096),
                                   (4928, 64, 1024), (400, 3072, 768)])
def test_the_plan_covers_the_output_and_fills_the_card(m, n, k):
    """int8: the tiles cover the output, the tile height is the cheapest of
    64-192 rows by waves x (G + 2), and the launch takes min(132, tiles)
    blocks."""
    plan = fa.gemm_plan(m, n, k, torch.int8)
    (cols, bands), (blocks, _) = plan.tiles, plan.grid
    assert cols * 128 >= n > (cols - 1) * 128 and bands * plan.rows >= m > (bands - 1) * plan.rows
    assert _cost(m, n, plan.rows // 64)[0] == min(_cost(m, n, g)[0] for g in (1, 2, 3))
    assert (blocks, plan.waves) == (min(132, bands * cols), -(-(bands * cols) // 132))


@pytest.mark.parametrize("m,n,rows,blocks,waves", [
    (400, 2304, 64, 126, 1),    # B/32 vision B = 8, q/k/v: a block a tile
    (400, 768, 64, 42, 1),      # its out-projection and fc2
    (400, 3072, 128, 96, 1),    # its fc1 at the two-launch route's shape
    (616, 1536, 64, 120, 1),    # B/32 text B = 8, q/k/v
    (616, 512, 64, 40, 1),      # its out-projection and fc2
    (616, 768, 64, 60, 1),      # L/14 text B = 8, out-projection and fc2
    (1028, 3072, 128, 132, 2),  # L/14 vision B = 4, q/k/v: 216 tiles
    (12800, 768, 192, 132, 4),  # B/32 vision B = 256, out and fc2: 402 tiles
    (4928, 768, 128, 132, 2),   # L/14 text B = 64: 234 tiles of 128 rows
    (3200, 768, 192, 102, 1),   # B/32 vision B = 64, out and fc2: 102 tiles
])
def test_the_int8_plan_at_the_small_and_the_cut_batches(m, n, rows, blocks, waves):
    """The height and grid the int8 plan gives the batches whose size or last
    wave decides them: at the B = 8 text and image layers 64-row tiles (128
    at fc1), a block a tile in one wave."""
    plan = fa.gemm_plan(m, n, n, torch.int8)
    assert (plan.rows, plan.grid[0], plan.waves) == (rows, blocks, waves), (m, n)


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
    """No longer 256: the tallest tile of both operand types is 192 rows,
    and the largest M either takes is 65535 of them (the chains stop at
    65535 x 64 rows)."""
    plan = fa.gemm_plan(65535 * 192, 64, 64, torch.int8)
    assert (plan.rows, plan.tiles, plan.grid) == (192, (1, 65535), (132, 1))
    assert "65535 row tiles" in fa.gemm_plan(65535 * 192 + 1, 64, 64, torch.int8).refused
    # bf16: the tallest tile, 192 rows
    assert fa.gemm_plan(65535 * 64 + 1, 64, 64, torch.bfloat16).rows == 192
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
