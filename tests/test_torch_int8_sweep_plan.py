"""K5's launch plan as the port mirrors it in Python
(ops/fused_metrics.py::int8_sweep_plan): query units and groups, tile rows,
passes, resident or reloaded queries, the ring, the tail mode and the
persistent grid, pinned at the main path's shapes and checked over many
others. The C side answers the same
(tests/test_torch_gpu.py::test_int8_sweep_plan_matches_the_kernel)."""

import dataclasses

import pytest

from image_retrieval_tpu_torch.ops import fused_metrics as fm

# the weights of the main path: the server's default (cosine only), the
# phase-6 wave's reference set (L1 live), and every term live
W_COS = (1.0, 0.0, 0.0, 0.0, 0.0)
W_REF = (1.0, 1.0, 1.0, 0.0, 0.5)
W_ALL = (0.3, 0.2, 0.5, 0.7, 0.1)
GALLERY = 1_049_728  # the L/14 int8 gallery: 2^20 rows and the planted ones
SMEM_LIMIT = 232448  # what one block may use on an H100 (227 KB)
BARRIERS = 2 * fm.SWEEP_MAX_STAGES * 8  # the full and empty mbarriers, static


def case_weights(case):
    """Weights whose live sums are those of the kernel's instantiation
    `case`: bit 0 the product, bit 1 the L1 sum, bit 2 the Linf max."""
    return (0.8 if case & 1 else 0.0, 0.6 if case & 2 else 0.0, 0.4 if case & 1 else 0.0,
            0.7 if case & 4 else 0.0, 0.3)


# (nq, d, weights) -> (qw, groups, tile_rows, passes, resident, q_rows, stages, smem)
PINNED = {
    (64, 768, W_REF): (8, 8, 32, 1, 1, 64, 16, 194816),
    (64, 768, W_COS): (32, 2, 128, 1, 1, 64, 5, 217344),
    (1, 768, W_COS): (32, 1, 256, 1, 1, 8, 5, 211232),
    (1, 768, W_REF): (8, 1, 256, 1, 1, 8, 5, 205088),
    (8, 768, W_ALL): (8, 1, 256, 1, 1, 8, 5, 205088),
    (64, 768, W_ALL): (8, 8, 32, 1, 1, 64, 16, 194816),
    (48, 768, W_REF): (8, 8, 32, 1, 1, 48, 16, 169664),
    (16, 768, W_REF): (8, 2, 128, 1, 1, 16, 10, 217664),
    (64, 512, W_REF): (8, 8, 32, 1, 1, 64, 16, 162048),
    (130, 768, W_REF): (8, 8, 32, 3, 0, 64, 16, 194816),
}


@pytest.mark.parametrize("key", list(PINNED), ids=[f"q{k[0]}-d{k[1]}-{k[2]}" for k in PINNED])
def test_plans_at_the_main_paths_shapes(key):
    nq, d, w = key
    p = fm.int8_sweep_plan(nq, GALLERY, d, w)
    assert (p.qw, p.groups, p.tile_rows, p.passes, p.resident, p.q_rows, p.stages,
            p.smem) == PINNED[key]
    assert p.boxes == d // 128 and p.tma == 1 and p.grid == 132
    assert p.tiles == -(-GALLERY // p.tile_rows)


@pytest.mark.parametrize("d", [8, 40, 100, 512, 768, 1024, 2048, 4096])
@pytest.mark.parametrize("case", range(8))
def test_queries_and_ring_fit_in_shared_memory(d, case):
    """Every plan's queries and ring, with the ring's alignment slack and the
    barriers, fit in the 227 KB a block may use, and the ring has two stages
    at least; query rows are whole boxes at a pitch of 32 mod 128 bytes."""
    w = case_weights(case)
    for nq in (1, 2, 7, 8, 9, 16, 17, 33, 48, 64, 65, 100, 128, 129, 200, 513, 2000):
        p = fm.int8_sweep_plan(nq, 10_000, d, w)
        q_bytes = p.q_rows * (p.q_pitch * 2 + 4)
        assert p.smem == (fm.SWEEP_ALIGN + p.stages * p.stage_bytes + q_bytes
                          + fm.sweep_epilogue_bytes(p.qw))
        assert p.smem + BARRIERS <= SMEM_LIMIT
        assert 2 <= p.stages <= fm.SWEEP_MAX_STAGES
        assert p.stage_bytes == p.tile_rows * fm.SWEEP_BOX_DIMS
        assert p.q_pitch >= p.boxes * fm.SWEEP_BOX_DIMS and p.boxes * 128 >= d
        assert (2 * p.q_pitch) % 128 == 32


@pytest.mark.parametrize("case", range(8))
def test_a_unit_per_warp(case):
    """Each pass's query groups times the tile's row units give the eight
    consumer warps one 32-row unit each; the passes hold every query; the
    unit's queries follow the live sums (8 with L1 or Linf, 32 with the
    product alone, 16 with none)."""
    w = case_weights(case)
    for nq in range(1, 300, 7):
        p = fm.int8_sweep_plan(nq, 5000, 768, w)
        assert p.qw == (8 if case & 6 else 32 if case & 1 else 16)
        assert p.groups in (1, 2, 4, 8)
        assert p.groups * (p.tile_rows // fm.SWEEP_UNIT_ROWS) == fm.SWEEP_WARPS
        assert p.passes == -(-nq // (p.groups * p.qw))
        assert (p.passes - 1) * p.groups * p.qw < nq <= p.passes * p.groups * p.qw
        # no more groups than the queries need
        assert p.groups == 1 or (p.groups // 2) * p.qw < nq


@pytest.mark.parametrize("d,w", [(768, W_REF), (768, W_COS), (512, W_ALL), (40, W_REF),
                                 (2048, W_COS)])
def test_queries_split_into_passes_when_they_do_not_fit(d, w):
    """Where the queries (rounded up to 8) fit beside two of the plan's
    stages, all are resident; else one pass's are, reloaded before each pass,
    and more than one pass is needed. Both happen over 1..1200 queries."""
    modes = set()
    for nq in range(1, 1200):
        p = fm.int8_sweep_plan(nq, 5000, d, w)
        room = (fm.SWEEP_SMEM_MAX - fm.SWEEP_ALIGN - fm.sweep_epilogue_bytes(p.qw)
                - 2 * p.stage_bytes)
        row = p.q_pitch * 2 + 4  # a bf16 query row and its norm
        rounded = -(-nq // 8) * 8
        if p.resident:
            assert p.q_rows == rounded and p.q_rows * row <= room
        else:
            assert p.q_rows == p.groups * p.qw and p.passes > 1
            assert rounded * row > room >= p.q_rows * row
        modes.add(p.resident)
    assert modes == {0, 1}


def test_wide_rows_take_fewer_groups_a_pass():
    """Where 64 query rows do not fit beside two stages, a pass holds fewer
    query groups and the tile more rows."""
    p = fm.int8_sweep_plan(64, 5000, 2048, W_REF)
    assert (p.qw, p.groups, p.tile_rows, p.passes, p.resident) == (8, 4, 64, 2, 0)
    # 32-query units of the product alone do not fit beside 2048-dim rows:
    # 16-query units take their place
    assert fm.int8_sweep_plan(64, 5000, 1920, W_COS).qw == 32
    p = fm.int8_sweep_plan(64, 5000, 2048, W_COS)
    assert (p.qw, p.groups, p.tile_rows, p.passes, p.resident) == (16, 2, 128, 2, 0)
    p = fm.int8_sweep_plan(64, 5000, 4096, W_COS)
    assert (p.qw, p.groups, p.tile_rows, p.passes, p.resident) == (16, 1, 256, 4, 0)


@pytest.mark.parametrize("aligned", [True, False])
def test_tail_mode_follows_d_mod_16(aligned):
    """TMA loads where the rows' stride is a multiple of 16 bytes and their
    base is aligned; else the producer warp copies (zero-filled)."""
    for d in range(1, 400):
        p = fm.int8_sweep_plan(5, 1000, d, W_REF, aligned)
        assert p.tma == int(aligned and d % 16 == 0), d
        assert p.boxes == -(-d // 128)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 256, 257, 1000, 33_791, GALLERY, 5_000_001])
@pytest.mark.parametrize("nq,w", [(1, W_COS), (64, W_REF), (64, W_COS), (16, W_ALL)])
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_the_persistent_grid_covers_every_tile_once(n, nq, w, sms):
    p = fm.int8_sweep_plan(nq, n, 768, w, sms=sms)
    assert p.grid == min(p.tiles, sms)
    walked = [t for b in range(p.grid) for t in p.block_tiles(b)]
    assert sorted(walked) == list(range(p.tiles))
    assert (p.tiles - 1) * p.tile_rows < n <= p.tiles * p.tile_rows
    per_block = [len(p.block_tiles(b)) for b in range(p.grid)]
    assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("nq,n,d,w,sms", [
    (0, 100, 768, W_REF, 132), (5, 0, 768, W_REF, 132), (5, 100, 0, W_REF, 132),
    (5, 100, 768, W_REF, 0), (64, 100, 5000, W_COS, 132), (1, 100, 20000, W_REF, 132),
    (600, 100, 12000, W_ALL, 132)])
def test_shapes_the_kernel_cannot_take_raise(nq, n, d, w, sms):
    with pytest.raises(ValueError, match="K5"):
        fm.int8_sweep_plan(nq, n, d, w, sms=sms)


def test_the_plan_has_the_c_fields_in_their_order():
    names = [f.name for f in dataclasses.fields(fm.Int8SweepPlan)]
    assert names == ["qw", "groups", "tile_rows", "passes", "resident", "q_rows", "q_pitch",
                     "boxes", "stages", "stage_bytes", "tma", "tiles", "grid", "smem"]
