"""The int4 screen's launch plan as the port mirrors it in Python
(ops/int4_screen.py::int4_screen_plan): query units, passes, resident or
reloaded queries and their windows of boxes, the ring within 227 KB, the
producer by the rows' stride and base, and the persistent grid, pinned at
the index's shapes and checked over many others, with every shape the
kernels took before their sweep accepted. The C side answers the same
(tests/test_torch_gpu.py::test_int4_screen_plan_matches_the_kernel)."""

import dataclasses

import pytest
import torch

from image_retrieval_tpu_torch.ops import int4_screen as k3

SMEM_LIMIT = 232448  # what one block may use on an H100 (227 KB)
BARRIERS = 2 * k3.SCREEN_MAX_STAGES * 8  # the full and empty mbarriers, static
SEGMENT = 1 << 21
# rows, row_offset: one row, a ragged few, a whole segment of the index, and
# the last segment of a gallery of 2^23 + 37 rows
ROWS = {"one": (1, 0), "ragged": (37, 0), "segment": (SEGMENT, 0),
        "last-segment": (37, 1 << 23)}

# (nq, d, qform) -> (qw, passes, resident, q_rows, q_boxes, q_pitch, boxes,
# stages, per_sm, smem), for any rows and an aligned base
PINNED = {
    (1, 40, "bf16"): (8, 1, 1, 8, 1, 576, 1, 3, 2, 113152),
    (1, 42, "bf16"): (8, 1, 1, 8, 1, 576, 1, 3, 2, 113152),
    (1, 64, "bf16"): (8, 1, 1, 8, 1, 576, 1, 3, 2, 113152),
    (1, 512, "bf16"): (8, 1, 1, 8, 2, 1088, 2, 2, 2, 84480),
    (1, 768, "bf16"): (8, 1, 1, 8, 3, 1600, 3, 2, 2, 88576),
    (3, 40, "bf16"): (8, 1, 1, 8, 1, 576, 1, 3, 2, 113152),
    (3, 42, "bf16"): (8, 1, 1, 8, 1, 576, 1, 3, 2, 113152),
    (3, 64, "bf16"): (8, 1, 1, 8, 1, 576, 1, 3, 2, 113152),
    (3, 512, "bf16"): (8, 1, 1, 8, 2, 1088, 2, 2, 2, 84480),
    (3, 768, "bf16"): (8, 1, 1, 8, 3, 1600, 3, 2, 2, 88576),
    (8, 40, "bf16"): (8, 1, 1, 8, 1, 576, 1, 3, 2, 113152),
    (8, 42, "bf16"): (8, 1, 1, 8, 1, 576, 1, 3, 2, 113152),
    (8, 64, "bf16"): (8, 1, 1, 8, 1, 576, 1, 3, 2, 113152),
    (8, 512, "bf16"): (8, 1, 1, 8, 2, 1088, 2, 2, 2, 84480),
    (8, 768, "bf16"): (8, 1, 1, 8, 3, 1600, 3, 2, 2, 88576),
    (64, 40, "bf16"): (64, 1, 1, 64, 1, 512, 1, 5, 1, 216064),
    (64, 42, "bf16"): (64, 1, 1, 64, 1, 512, 1, 5, 1, 216064),
    (64, 64, "bf16"): (64, 1, 1, 64, 1, 512, 1, 5, 1, 216064),
    (64, 512, "bf16"): (64, 1, 1, 64, 2, 1024, 2, 4, 1, 216064),
    (64, 768, "bf16"): (64, 1, 1, 64, 3, 1536, 3, 3, 1, 216064),
    (130, 40, "bf16"): (64, 3, 1, 192, 1, 512, 1, 3, 1, 216064),
    (130, 42, "bf16"): (64, 3, 1, 192, 1, 512, 1, 3, 1, 216064),
    (130, 64, "bf16"): (64, 3, 1, 192, 1, 512, 1, 3, 1, 216064),
    (130, 512, "bf16"): (64, 3, 0, 64, 2, 1024, 2, 4, 1, 216064),
    (130, 768, "bf16"): (64, 3, 0, 64, 3, 1536, 3, 3, 1, 216064),
    (257, 40, "bf16"): (64, 5, 0, 64, 1, 512, 1, 5, 1, 216064),
    (257, 42, "bf16"): (64, 5, 0, 64, 1, 512, 1, 5, 1, 216064),
    (257, 64, "bf16"): (64, 5, 0, 64, 1, 512, 1, 5, 1, 216064),
    (257, 512, "bf16"): (64, 5, 0, 64, 2, 1024, 2, 4, 1, 216064),
    (257, 768, "bf16"): (64, 5, 0, 64, 3, 1536, 3, 3, 1, 216064),
    (1, 40, "i8"): (8, 1, 1, 8, 1, 288, 1, 3, 2, 110848),
    (1, 42, "i8"): (8, 1, 1, 8, 1, 288, 1, 3, 2, 110848),
    (1, 64, "i8"): (8, 1, 1, 8, 1, 288, 1, 3, 2, 110848),
    (1, 512, "i8"): (8, 1, 1, 8, 2, 544, 2, 3, 2, 112896),
    (1, 768, "i8"): (8, 1, 1, 8, 3, 800, 3, 3, 2, 114944),
    (3, 40, "i8"): (8, 1, 1, 8, 1, 288, 1, 3, 2, 110848),
    (3, 42, "i8"): (8, 1, 1, 8, 1, 288, 1, 3, 2, 110848),
    (3, 64, "i8"): (8, 1, 1, 8, 1, 288, 1, 3, 2, 110848),
    (3, 512, "i8"): (8, 1, 1, 8, 2, 544, 2, 3, 2, 112896),
    (3, 768, "i8"): (8, 1, 1, 8, 3, 800, 3, 3, 2, 114944),
    (8, 40, "i8"): (8, 1, 1, 8, 1, 288, 1, 3, 2, 110848),
    (8, 42, "i8"): (8, 1, 1, 8, 1, 288, 1, 3, 2, 110848),
    (8, 64, "i8"): (8, 1, 1, 8, 1, 288, 1, 3, 2, 110848),
    (8, 512, "i8"): (8, 1, 1, 8, 2, 544, 2, 3, 2, 112896),
    (8, 768, "i8"): (8, 1, 1, 8, 3, 800, 3, 3, 2, 114944),
    (64, 40, "i8"): (64, 1, 1, 64, 1, 288, 1, 5, 1, 201728),
    (64, 42, "i8"): (64, 1, 1, 64, 1, 288, 1, 5, 1, 201728),
    (64, 64, "i8"): (64, 1, 1, 64, 1, 288, 1, 5, 1, 201728),
    (64, 512, "i8"): (64, 1, 1, 64, 2, 544, 2, 5, 1, 218112),
    (64, 768, "i8"): (64, 1, 1, 64, 3, 800, 3, 4, 1, 201728),
    (130, 40, "i8"): (64, 3, 1, 192, 1, 288, 1, 4, 1, 205824),
    (130, 42, "i8"): (64, 3, 1, 192, 1, 288, 1, 4, 1, 205824),
    (130, 64, "i8"): (64, 3, 1, 192, 1, 288, 1, 4, 1, 205824),
    (130, 512, "i8"): (64, 3, 1, 192, 2, 544, 2, 3, 1, 222208),
    (130, 768, "i8"): (64, 3, 0, 64, 3, 800, 3, 4, 1, 201728),
    (257, 40, "i8"): (64, 5, 1, 320, 1, 288, 1, 3, 1, 209920),
    (257, 42, "i8"): (64, 5, 1, 320, 1, 288, 1, 3, 1, 209920),
    (257, 64, "i8"): (64, 5, 1, 320, 1, 288, 1, 3, 1, 209920),
    (257, 512, "i8"): (64, 5, 0, 64, 2, 544, 2, 5, 1, 218112),
    (257, 768, "i8"): (64, 5, 0, 64, 3, 800, 3, 4, 1, 201728),
}


@pytest.mark.parametrize("key", list(PINNED), ids=[f"q{k[0]}-d{k[1]}-{k[2]}" for k in PINNED])
def test_plans_pinned(key):
    nq, d, qform = key
    for rows, off in ROWS.values():
        for aligned in (True, False):
            p = k3.int4_screen_plan(nq, d, rows, off, aligned, qform)
            assert (p.qw, p.passes, p.resident, p.q_rows, p.q_boxes, p.q_pitch, p.boxes,
                    p.stages, p.per_sm, p.smem) == PINNED[key]


@pytest.mark.parametrize("where", list(ROWS))
@pytest.mark.parametrize("d", [40, 42, 64, 512, 768])
@pytest.mark.parametrize("qform", k3.QFORMS)
def test_tiles_grid_and_producer(where, d, qform):
    """256-row tiles over the segment, two blocks an SM at most for units
    of 8 queries, TMA where the rows are 16-byte multiples from an aligned
    base (D = 64, 512, 768), else the producer warp copies (D = 40, 42, or
    any unaligned base)."""
    rows, off = ROWS[where]
    for aligned in (True, False):
        for sms in (132, 114):
            p = k3.int4_screen_plan(8, d, rows, off, aligned, qform, sms)
            assert p.tile_rows == 256 and p.stage_bytes == 256 * 128
            assert p.per_sm == 2 and p.tiles == -(-rows // 256)
            assert p.grid == min(p.tiles, 2 * sms)
            assert p.tma == int(aligned and d in (64, 512, 768))
            # block b walks tiles b, b + grid, ...: each tile once
            assert sorted(t for b in range(p.grid) for t in range(b, p.tiles, p.grid)) == list(
                range(p.tiles))


def test_the_main_paths_shapes():
    """A SearchServer micro-batch (Q = 64) and a single query over a segment
    of the index's 512-d rows: one pass, every query resident, TMA, the
    ring beside them; Q = 64 at D = 512 is 64 KB of bf16 queries, one block
    an SM, products on wgmma (not with int8 queries); a single query takes
    two blocks an SM of two stages each."""
    p64 = k3.int4_screen_plan(64, 512, SEGMENT)
    assert (p64.passes, p64.resident, p64.q_rows, p64.tma, p64.grid) == (1, 1, 64, 1, 132)
    assert p64.q_rows * p64.q_pitch == 64 * 1024 and k3.screen_uses_wgmma("bf16", p64.qw)
    assert p64.stages == 4 and p64.per_sm == 1 and p64.tiles == SEGMENT // 256
    p1 = k3.int4_screen_plan(1, 512, SEGMENT)
    assert (p1.qw, p1.passes, p1.resident, p1.stages, p1.per_sm, p1.grid) == (8, 1, 1, 2, 2, 264)
    assert k3.int4_screen_plan(64, 512, SEGMENT, qform="i8").stages == 5
    assert not k3.screen_uses_wgmma("i8", 64) and not k3.screen_uses_wgmma("bf16", 32)


@pytest.mark.parametrize("qform", k3.QFORMS)
@pytest.mark.parametrize("d", [2, 40, 42, 64, 100, 512, 768, 1024, 2048, 2560, 8192, 16384,
                               65536])
def test_queries_and_ring_fit_in_shared_memory(qform, d):
    """Every plan's queries, ring and scratch, with the ring's alignment
    slack and the barriers, fit in the 227 KB a block may use (half of the
    SM's 228 KB, less the 1 KB the card keeps a block, where two blocks
    share an SM), with two stages at least; query rows are whole boxes at a pitch of 64 (bf16) or
    32 (int8) mod 128 bytes; resident plans hold every pass's queries over
    the whole of D, the others one pass's over a window of boxes."""
    if qform == "i8" and d > k3.I8_MAX_DIM:
        with pytest.raises(ValueError, match="2048"):
            k3.int4_screen_plan(1, d, 100, qform=qform)
        return
    elem = 1 if qform == "i8" else 2
    for nq in (1, 2, 7, 8, 9, 16, 17, 33, 48, 64, 65, 100, 130, 200, 257, 513, 2000):
        p = k3.int4_screen_plan(nq, d, 10_000, 0, True, qform)
        assert p.smem == (k3.SCREEN_ALIGN + p.stages * p.stage_bytes + p.q_rows * p.q_pitch
                          + k3.screen_epilogue_bytes(p.qw))
        assert p.per_sm * (p.smem + BARRIERS + 1024) <= SMEM_LIMIT + 1024
        assert p.per_sm == (2 if p.qw <= 16 else 1)
        assert 2 <= p.stages <= k3.SCREEN_MAX_STAGES
        assert p.boxes == -(-d // 256) and 1 <= p.q_boxes <= p.boxes
        if k3.screen_uses_wgmma(qform, p.qw):  # 128-byte rows of swizzled tiles
            assert p.q_pitch == p.q_boxes * 512 and p.q_rows % 64 == 0
        else:
            assert p.q_pitch == p.q_boxes * 256 * elem + 32 * elem
            assert p.q_pitch % 128 == 32 * elem
        assert p.qw in (8, 16, 32, 64) and (p.qw >= nq or p.qw == 64)
        assert p.passes == -(-nq // p.qw)
        if p.resident:
            assert p.q_rows == p.passes * p.qw and p.q_boxes == p.boxes
        else:
            assert p.q_rows == p.qw
            # one more box, or every pass resident, would not have fitted
            room = k3.screen_smem_max(p.per_sm) - k3.SCREEN_ALIGN \
                - k3.screen_epilogue_bytes(p.qw) - 2 * p.stage_bytes
            assert p.passes * p.qw * k3.screen_q_row_bytes(p.boxes, qform, p.qw) > room
            assert (p.q_boxes == p.boxes
                    or p.qw * k3.screen_q_row_bytes(p.q_boxes + 1, qform, p.qw) > room)


@pytest.mark.parametrize("qform", k3.QFORMS)
def test_every_shape_the_old_kernels_took_is_taken(qform):
    """The kernels before the sweep took any Q >= 1, any even D (<= 2048 for
    int8 queries), any rows >= 1 and any row_offset >= 0, from any base."""
    dims = [d for d in range(2, 4097, 2) if qform == "bf16" or d <= 2048]
    for d in dims:
        for nq in (1, 64, 65, 300):
            k3.int4_screen_plan(nq, d, 37, 0, False, qform)
    for nq in range(1, 300):
        k3.int4_screen_plan(nq, 512, SEGMENT, 0, True, qform)
    for rows in (1, 2, 255, 256, 257, 1000, SEGMENT, (1 << 31) - 1):
        for off in (0, 1, 3, 1 << 23, (1 << 31) - 1, 1 << 40):
            p = k3.int4_screen_plan(5, 512, rows, off, True, qform)
            assert p.tma == int(off + rows <= (1 << 31) - 1)


@pytest.mark.parametrize("nq,d,rows,off,qform", [
    (0, 512, 100, 0, "bf16"), (1, 0, 100, 0, "bf16"), (1, 41, 100, 0, "bf16"),
    (1, 512, 0, 0, "bf16"), (1, 512, 100, -1, "bf16"), (1, 2050, 100, 0, "i8"),
    (1, 513, 100, 0, "i8"), (0, 64, 1, 0, "i8"),
])
def test_refuses_what_neither_form_takes(nq, d, rows, off, qform):
    with pytest.raises(ValueError):
        k3.int4_screen_plan(nq, d, rows, off, True, qform)


def test_refuses_an_unknown_query_form():
    with pytest.raises(ValueError, match="qform"):
        k3.int4_screen_plan(1, 512, 100, qform="f32")


def test_plan_is_the_c_sides_field_order():
    assert [f.name for f in dataclasses.fields(k3.Int4ScreenPlan)] == [
        "qw", "tile_rows", "passes", "resident", "q_rows", "q_boxes", "q_pitch", "boxes",
        "stages", "stage_bytes", "tma", "tiles", "per_sm", "grid", "smem"]


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers are their plain versions and count no
    launch, whatever the plan."""
    g = torch.Generator().manual_seed(3)
    packed = torch.randint(0, 256, (300, 20), dtype=torch.uint8, generator=g)
    scales = torch.rand(300, generator=g)
    valid = torch.rand(300, generator=g) > 0.1
    qu = torch.randn(3, 40, generator=g).to(torch.bfloat16)
    q8, _ = k3.quantize_queries_i8(qu)
    before = k3.int4_screen_scores.launches, k3.int4_screen_scores_i8.launches
    assert torch.equal(k3.int4_screen_scores(qu, packed, scales, valid, 7, 200),
                       k3.int4_screen_scores_reference(qu, packed, scales, valid, 7, 200))
    assert torch.equal(k3.int4_screen_scores_i8(q8, packed, scales, valid, 7, 200),
                       k3.int4_screen_scores_i8_reference(q8, packed, scales, valid, 7, 200))
    assert (k3.int4_screen_scores.launches, k3.int4_screen_scores_i8.launches) == before
