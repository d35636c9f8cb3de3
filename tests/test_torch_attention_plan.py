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
# at head_dim 64. bf16: rows of 64 + 8 columns (144 bytes), K and V rounded
# up to 16 rows, four 16-row Q tiles; where two warps share a tile (81-288
# keys), per row group two halves' 16 row maxima and sums and one half's
# 16 x 64 PV sums in f32. f32: the scalar kernel's tiles.
SPLIT = 4 * (2 * 2 * 16 + 16 * 64) * 4
PRESETS = {
    # one (image, head): split into groups of at least four tiles
    (50, BF16, 1): (1, 64, 1, (2 * 64 + 64) * 144),
    (77, BF16, 1): (1, 48, 2, (2 * 80 + 64) * 144),
    (197, BF16, 1): (2, 64, 4, (2 * 208 + 64) * 144 + SPLIT),
    (257, BF16, 1): (2, 64, 5, (2 * 272 + 64) * 144 + SPLIT),
    # the main paths' batches: one block per (image, head) fills the card
    (50, BF16, 256 * 12): (1, 64, 3072, 27648),   # ViT-B/32 vision, B = 256
    (50, BF16, 8 * 12): (1, 64, 96, 27648),       # ViT-B/32 vision, B = 8
    (77, BF16, 64 * 8): (1, 80, 512, 32256),      # ViT-B/32 text, B = 64
    (197, BF16, 4 * 12): (2, 64, 192, 69120 + SPLIT),     # ViT-B/16 vision, B = 4
    (257, BF16, 128 * 16): (2, 272, 2048, 87552 + SPLIT),  # ViT-L/14 vision, B = 128
    (257, BF16, 4 * 16): (2, 64, 320, 87552 + SPLIT),     # ViT-L/14 vision, B = 4
    (50, F32, 1): (0, 64, 1, 4 * (52 * 68 + 52 * 64 + 64 * 68 + 64 * 52)),
    (77, F32, 1): (0, 64, 2, 4 * (80 * 68 + 80 * 64 + 64 * 68 + 64 * 80)),
    (197, F32, 1): (0, 64, 4, 4 * (200 * 68 + 200 * 64 + 64 * 68 + 64 * 200)),
    (257, F32, 128 * 16): (0, 64, 5 * 2048, 4 * (260 * 68 + 260 * 64 + 64 * 68 + 64 * 260)),
}


@pytest.mark.parametrize("t,dtype,pairs", list(PRESETS))
def test_plan_at_the_presets(t, dtype, pairs):
    plan = fa.attention_plan(t, 64, dtype, pairs)
    assert (plan.route, plan.rows_per_block, plan.blocks, plan.smem_bytes) == \
        PRESETS[(t, dtype, pairs)]
    assert plan.refused is None and plan.smem_bytes <= 232448
    assert fa.ATTENTION_ROUTES[plan.route].startswith("bf16" if dtype == BF16 else "f32")


@pytest.mark.parametrize("t,hd,route", [
    (80, 128, 1), (81, 64, 2), (288, 64, 2), (289, 64, 3), (257, 80, 3), (257, 128, 3),
    (768, 64, 3)])
def test_bf16_form_by_keys_and_head_dim(t, hd, route):
    """Scores computed once while a tile's 16 rows of them fit in registers
    (80 keys in one warp, or 288 at head_dim <= 64 in two), three passes
    past that."""
    plan = fa.attention_plan(t, hd, BF16)
    assert plan.refused is None and plan.route == route


@pytest.mark.parametrize("t,hd,dtype,why", [
    (50, 2, BF16, "head_dim 2 must be a multiple of 4"),
    (50, 66, F32, "head_dim 66 must be a multiple of 4"),
    (50, 132, BF16, "at most 128"),
    (257, 128, F32, "do not fit"),   # f32 K and V alone are 257 KB
    (600, 64, F32, "do not fit"),
    (769, 64, BF16, "do not fit"),   # bf16 K and V fit up to 768 tokens at head_dim 64
    (385, 128, BF16, "do not fit"),  # and up to 384 at 128
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
