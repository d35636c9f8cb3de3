"""The attention kernel's launch plan as the port mirrors it in Python
(ops/flash_attention.py::attention_plan): blocks, query rows per block,
shared memory and kernel form at every preset's attention shape, and the
shapes it refuses with their reasons. The C side answers the same
(tests/test_torch_gpu.py::test_attention_plan_matches_the_kernels)."""

import pytest
import torch

from image_retrieval_tpu_torch.ops import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32

# (t, dtype, pairs) -> (route, rows per block, blocks, shared memory bytes)
# at head_dim 64. bf16 at 81-288 keys (t rounded up to 16): the wgmma form,
# one block an SM of an H100 (132) over work items of 64-row query tiles, its
# shared memory two K and V stages of 288 rows of 128 bytes, four 64-row Q
# stages and 1,024 bytes of alignment; the rows are one work item's. Other
# bf16 shapes: rows of 64 + 8 columns (144 bytes), K and V rounded up to 16
# rows, four 16-row Q tiles. f32: the scalar kernel's tiles.
WG = 2 * 2 * 288 * 128 + 4 * 64 * 128 + 1024
PRESETS = {
    # one (image, head): split into groups of at least four tiles; the wgmma
    # form a 64-row tile an item
    (50, BF16, 1): (1, 64, 1, (2 * 64 + 64) * 144),
    (77, BF16, 1): (1, 48, 2, (2 * 80 + 64) * 144),
    (197, BF16, 1): (4, 64, 4, WG),
    (257, BF16, 1): (4, 64, 5, WG),
    # the main paths' batches: one block per (image, head) fills the card;
    # the wgmma form's persistent blocks walk whole (image, head)s
    (50, BF16, 256 * 12): (1, 64, 3072, 27648),   # ViT-B/32 vision, B = 256
    (50, BF16, 8 * 12): (1, 64, 96, 27648),       # ViT-B/32 vision, B = 8
    (77, BF16, 64 * 8): (1, 80, 512, 32256),      # ViT-B/32 text, B = 64
    (197, BF16, 4 * 12): (4, 128, 96, WG),        # ViT-B/16 vision, B = 4: 48 pairs x 2 items
    (257, BF16, 128 * 16): (4, 320, 132, WG),     # ViT-L/14 vision, B = 128
    (257, BF16, 4 * 16): (4, 128, 132, WG),       # ViT-L/14 vision, B = 4: 64 pairs x 3 items
    (50, F32, 1): (0, 64, 1, 4 * (52 * 68 + 52 * 64 + 64 * 68 + 64 * 52)),
    (77, F32, 1): (0, 64, 2, 4 * (80 * 68 + 80 * 64 + 64 * 68 + 64 * 80)),
    (197, F32, 1): (0, 64, 4, 4 * (200 * 68 + 200 * 64 + 64 * 68 + 64 * 200)),
    (257, F32, 128 * 16): (0, 64, 5 * 2048, 4 * (260 * 68 + 260 * 64 + 64 * 68 + 64 * 260)),
    # the edges of the wgmma form: 81 and 288 tokens take it, 289 do not
    (81, BF16, 8 * 12): (4, 64, 132, WG),         # 96 pairs x 2 one-tile items
    (288, BF16, 128 * 16): (4, 320, 132, WG),
    (289, BF16, 128 * 16): (3, 304, 2048, (2 * 304 + 64) * 144),
}


@pytest.mark.parametrize("t,dtype,pairs", list(PRESETS))
def test_plan_at_the_presets(t, dtype, pairs):
    plan = fa.attention_plan(t, 64, dtype, pairs)
    assert (plan.route, plan.rows_per_block, plan.blocks, plan.smem_bytes) == \
        PRESETS[(t, dtype, pairs)]
    assert plan.refused is None and plan.smem_bytes <= 232448
    assert fa.ATTENTION_ROUTES[plan.route].startswith("bf16" if dtype == BF16 else "f32")


@pytest.mark.parametrize("t,hd,route", [
    (80, 128, 1), (81, 64, 4), (288, 64, 4), (289, 64, 3), (257, 80, 3), (257, 128, 3),
    (768, 64, 3), (50, 64, 1), (77, 64, 1), (80, 64, 1), (96, 64, 4), (197, 64, 4),
    (257, 64, 4), (257, 32, 2), (257, 48, 2), (81, 16, 2), (288, 32, 2), (289, 32, 3)])
def test_bf16_form_by_keys_and_head_dim(t, hd, route):
    """At head_dim 64 and 81-288 keys the wgmma form (a 64-row tile's whole
    rows in a warpgroup's registers); elsewhere scores computed once while a
    tile's 16 rows of them fit in registers (80 keys in one warp, or 288 at
    head_dim < 64 in two), three passes past that."""
    plan = fa.attention_plan(t, hd, BF16)
    assert plan.refused is None and plan.route == route


# (t, hd) -> (route, rows per block, shared memory bytes) at L/14's 2,048
# (image, head) pairs, off head_dim 64: the mma.sync forms, rows of 16 kd +
# 8 columns; two warps to a tile add per row group two halves' 16 maxima and
# sums and one half's 16 x 16 kd PV sums in f32.
OFF_64 = {
    (257, 32): (2, 272, (2 * 272 + 64) * 80 + 4 * (2 * 2 * 16 + 2 * 2 * 4 * 32) * 4),
    (257, 128): (3, 272, (2 * 272 + 64) * 272),
    (257, 48): (2, 272, (2 * 272 + 64) * 144 + 4 * (2 * 2 * 16 + 2 * 4 * 4 * 32) * 4),
}


@pytest.mark.parametrize("t,hd", list(OFF_64))
def test_plan_off_head_dim_64(t, hd):
    """The wgmma form takes head_dim 64 only: the L/14 token count at other
    head widths keeps the mma.sync forms, one block per (image, head)."""
    plan = fa.attention_plan(t, hd, BF16, 2048)
    assert (plan.route, plan.rows_per_block, plan.smem_bytes) == OFF_64[(t, hd)]
    assert plan.blocks == 2048 and plan.refused is None


@pytest.mark.parametrize("t,hd,dtype,why", [
    (50, 2, BF16, "head_dim 2 must be a multiple of 4"),
    (50, 66, F32, "head_dim 66 must be a multiple of 4"),
    (50, 132, BF16, "at most 128"),
    (257, 128, F32, "do not fit"),   # f32 K and V alone are 257 KB
    (600, 64, F32, "do not fit"),
    (769, 64, BF16, "do not fit"),   # bf16 K and V fit up to 768 tokens at head_dim 64
    (385, 128, BF16, "do not fit"),  # and up to 384 at 128
    (257, 66, BF16, "head_dim 66 must be a multiple of 4"),
    (257, 136, BF16, "at most 128"),
    (1500, 32, BF16, "do not fit"),  # and up to 1,420 at 32
])
def test_refused_shapes_say_why(t, hd, dtype, why):
    plan = fa.attention_plan(t, hd, dtype, pairs=8)
    assert plan.refused is not None and why in plan.refused
    assert plan.rows_per_block == 0 and plan.blocks == 0
    with pytest.raises(ValueError, match=why):
        fa._check_attention_shape("tiled_attention", t, 2 * hd, 2, dtype)


def test_bf16_takes_what_f32_refuses():
    for t, hd in ((257, 128), (600, 64), (768, 64), (384, 128)):
        assert fa.attention_plan(t, hd, F32).refused is not None
        assert fa.attention_plan(t, hd, BF16).refused is None
    assert fa._check_attention_shape("multihead_attention", 257, 1024, 8, BF16) == 128


def test_check_attention_shape_rejects_a_ragged_width_and_other_dtypes():
    with pytest.raises(ValueError, match="not a multiple of heads"):
        fa._check_attention_shape("attention_block", 50, 100, 3, BF16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.attention_plan(50, 64, torch.float16)
