"""The f32 sweep of K4, K6 and K7 (csrc/f32_sweep_sm90.cuh) as the port
mirrors it in Python: its launch plan (ops/fused_metrics.py::f32_sweep_plan)
held to its rules at the main path's shapes and over many others, and the
split-TF32 product (ops/fused_metrics.py::split_tf32_dots) held to the
contract's 1e-5 against float64. The C side answers the same plans
(tests/test_torch_gpu.py::test_f32_sweep_plan_matches_the_kernel)."""

import dataclasses

import numpy as np
import pytest
import torch

from image_retrieval_tpu_torch.ops import fused_metrics as fm

W_COS = (1.0, 0.0, 0.0, 0.0, 0.0)
W_REF = (1.0, 1.0, 1.0, 0.0, 0.5)
W_ALL = (0.3, 0.2, 0.5, 0.7, 0.1)
W_MAG = (0.0, 0.0, 0.0, 0.0, 1.0)
GALLERY = 1_001_344  # phase 6's f32 gallery: 1,000,256 rows and the planted ones
SMEM_LIMIT = 232448  # what one block may use on an H100 (227 KB)
BARRIERS = 2 * fm.SWEEP_MAX_STAGES * 8  # the full and empty mbarriers, static
CONTRACT = 1e-5  # scores within 1e-5 of a float64 oracle (PERF.md section 2)


def case_weights(case):
    """Weights whose live sums are those of the kernel's instantiation
    `case`: bit 0 the cosine's product, bit 1 the L1 sum, bit 2 the Linf
    max, bit 3 the Gram-form L2 (K4: the product on the CUDA cores)."""
    return (0.8 if case & 1 else 0.0, 0.6 if case & 2 else 0.0, 0.4 if case & 8 else 0.0,
            0.7 if case & 4 else 0.0, 0.3)


# (nq, d, weights, row_bytes, k) -> (qw, groups, tile_rows, passes, resident, q_rows,
# stage_boxes, stages, lists, smem); weights None: K6 and K7 (every term)
PINNED = {
    (64, 512, None, 4, 0): (8, 8, 16, 1, 1, 64, 4, 12, 0, 231424),
    (1, 512, None, 4, 0): (8, 1, 128, 1, 1, 8, 1, 13, 0, 230528),
    (64, 768, None, 4, 0): (8, 8, 16, 1, 1, 64, 4, 4, 0, 231424),
    (64, 512, W_COS, 4, 10): (32, 2, 64, 1, 1, 64, 1, 7, 528, 228352),
    (1, 512, W_COS, 4, 10): (32, 1, 128, 1, 1, 8, 1, 10, 1056, 219264),
    (64, 512, W_REF, 4, 10): (8, 8, 16, 1, 1, 64, 4, 10, 132, 224512),
    (1, 512, W_REF, 4, 10): (8, 1, 128, 1, 1, 8, 1, 12, 1056, 223616),
    (64, 512, W_COS, 4, 64): (8, 8, 16, 1, 1, 64, 4, 7, 132, 227584),
    (64, 512, W_REF, 2, 10): (8, 8, 16, 1, 1, 64, 4, 10, 132, 224512),
    (65, 512, None, 4, 0): (8, 8, 16, 2, 1, 64, 4, 12, 0, 231424),
}


@pytest.mark.parametrize("key", list(PINNED),
                         ids=[f"q{k[0]}-d{k[1]}-{k[2]}-b{k[3]}-k{k[4]}" for k in PINNED])
def test_plans_at_the_main_paths_shapes(key):
    nq, d, w, row_bytes, k = key
    p = fm.f32_sweep_plan(nq, GALLERY, d, w, row_bytes, k)
    assert (p.qw, p.groups, p.tile_rows, p.passes, p.resident, p.q_rows, p.stage_boxes, p.stages,
            p.lists, p.smem) == PINNED[key]
    assert p.box_dims == 128 // row_bytes and p.boxes == -(-d // p.box_dims)
    assert p.tma == 1 and p.tiles == -(-GALLERY // p.tile_rows)
    assert p.grid == min(p.tiles, max(1, 132 // p.passes))


@pytest.mark.parametrize("d", [1, 8, 37, 40, 512, 768, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("case", range(16))
@pytest.mark.parametrize("row_bytes,k", [(4, 0), (4, 10), (4, 64), (2, 1), (2, 64)])
def test_shared_memory_fits(d, case, row_bytes, k):
    """Every plan's queries, ring and (K4) lists, with the ring's alignment
    slack and the barriers, fit in the 227 KB a block may use, and the ring
    has two stages at least; query rows are whole boxes at a pitch of 16 mod
    128 bytes."""
    w = case_weights(case)
    for nq in (1, 2, 7, 8, 9, 16, 17, 33, 48, 64, 65, 100, 128, 129, 200, 513, 2000):
        p = fm.f32_sweep_plan(nq, 10_000, d, w, row_bytes, k)
        assert p.smem == (fm.SWEEP_ALIGN + p.stages * p.stage_bytes + p.q_rows * p.q_pitch * 4
                          + fm.f32_topk_bytes(p.qw, k))
        assert p.smem + BARRIERS <= SMEM_LIMIT
        assert 2 <= p.stages <= fm.SWEEP_MAX_STAGES
        assert p.stage_bytes == p.stage_boxes * p.tile_rows * fm.F32_BOX_BYTES
        assert 1 <= p.stage_boxes <= p.boxes
        # a stage of one box, or as many as make about 8 KB
        assert p.stage_boxes == 1 or p.stage_bytes <= fm.F32_STAGE_TARGET
        assert (p.tile_rows * fm.F32_BOX_BYTES) % 1024 == 0  # every box on the swizzle's alignment
        assert p.q_pitch >= p.boxes * p.box_dims and p.boxes * p.box_dims >= d
        assert (4 * p.q_pitch) % 128 == 16


@pytest.mark.parametrize("case", range(16))
@pytest.mark.parametrize("k", [0, 10, 64])
def test_the_passes_cover_every_query(case, k):
    """Each pass's query groups times the tile's row units give the eight
    consumer warps one 16-row unit each; the passes hold every query, and
    no pass is empty; the unit's queries follow the live sums (32 with the
    cosine's product alone, where they fit beside K4's lists, else 8)."""
    w = case_weights(case)
    for nq in range(1, 300, 7):
        p = fm.f32_sweep_plan(nq, 5000, 768, w, 4, k)
        assert p.qw == 32 or p.qw == 8
        assert p.qw == 8 or case == 1
        assert p.groups in (1, 2, 4, 8)
        assert p.groups * (p.tile_rows // fm.F32_UNIT_ROWS) == fm.SWEEP_WARPS
        pass_q = p.groups * p.qw
        assert p.passes == -(-nq // pass_q)
        assert (p.passes - 1) * pass_q < nq <= p.passes * pass_q
        assert p.groups == 1 or (p.groups // 2) * p.qw < nq  # no more groups than needed
        if p.resident:
            assert p.q_rows == min(pass_q, -(-nq // 8) * 8)
        assert p.lists == (p.grid * (fm.SWEEP_WARPS // p.groups) if k else 0)


@pytest.mark.parametrize("row_bytes", [4, 2])
@pytest.mark.parametrize("w_l2", [0.0, 0.4])
def test_the_gram_form_l2_takes_eight_query_units(row_bytes, w_l2):
    """K4 takes the Gram-form L2's product on the CUDA cores, which the
    plan gives 8-query units; the cosine alone takes 32-query units and the
    tensor cores, with or without |dmag|."""
    for nq in (1, 8, 33, 64, 65):
        for w_mag in (0.0, 0.5):
            p = fm.f32_sweep_plan(nq, GALLERY, 512, (1.0, 0.0, w_l2, 0.0, w_mag), row_bytes, 10)
            assert p.qw == (8 if w_l2 else 32), (nq, w_mag)


@pytest.mark.parametrize("row_bytes", [4, 2])
@pytest.mark.parametrize("w", [W_COS, W_REF, W_MAG, None])
def test_one_query_gives_every_warp_its_own_rows(row_bytes, w):
    """At Q = 1 a pass is one query group, so the tile has eight row units:
    every consumer warp sweeps 16 rows of its own, none idles."""
    for d in (37, 512, 768, 1024):
        p = fm.f32_sweep_plan(1, GALLERY, d, w, row_bytes, 0 if w is None else 10)
        assert p.groups == 1 and p.passes == 1
        assert p.tile_rows // fm.F32_UNIT_ROWS == fm.SWEEP_WARPS
        assert p.grid == 132


@pytest.mark.parametrize("n", [1, 15, 16, 17, 127, 128, 129, 1000, 33_791, GALLERY, 5_000_001])
@pytest.mark.parametrize("nq,w,k", [(1, W_COS, 10), (64, W_REF, 10), (64, W_COS, 10),
                                    (64, None, 0), (200, None, 0)])
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_the_tiles_cover_every_row(n, nq, w, k, sms):
    """In each pass the persistent blocks walk every tile once, in
    ascending order within a block, and the tiles cover every row."""
    p = fm.f32_sweep_plan(nq, n, 512, w, 4, k, sms=sms)
    assert p.grid == min(p.tiles, max(1, sms // p.passes))
    walked = [t for b in range(p.grid) for t in p.block_tiles(b)]
    assert sorted(walked) == list(range(p.tiles))
    assert all(list(p.block_tiles(b)) == sorted(p.block_tiles(b)) for b in range(p.grid))
    assert (p.tiles - 1) * p.tile_rows < n <= p.tiles * p.tile_rows
    per_block = [len(p.block_tiles(b)) for b in range(p.grid)]
    assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("row_bytes", [4, 2])
def test_tma_only_where_d_and_the_base_allow(aligned, row_bytes):
    """TMA loads where a row's stride is a multiple of 16 bytes (d % 4 == 0
    in f32, d % 8 == 0 in bf16) and the base is aligned; else the producer
    warp copies (zero-filled)."""
    for d in range(1, 300):
        p = fm.f32_sweep_plan(5, 1000, d, W_REF, row_bytes, 10, aligned)
        assert p.tma == int(aligned and (d * row_bytes) % 16 == 0), d
        assert p.boxes == -(-d // (128 // row_bytes))


@pytest.mark.parametrize("d,nq,resident", [(512, 64, 1), (768, 64, 1), (4096, 64, 1),
                                           (4096, 65, 1), (6144, 8, 1), (8192, 1, 0),
                                           (8192, 64, 0), (50_000, 3, 0)])
def test_every_width_is_taken(d, nq, resident):
    """Queries too wide for one pass in shared memory are read from the
    wrapper's padded copy: no width is refused."""
    p = fm.f32_sweep_plan(nq, 1000, d)
    assert p.resident == resident and (p.q_rows == 0) == (resident == 0)
    q = torch.arange(nq * d, dtype=torch.float32).reshape(nq, d)
    pad = fm._padded_queries(p, q)
    if resident:
        assert pad is None
    else:
        assert pad.shape == (-(-nq // 8) * 8, p.q_pitch)
        assert torch.equal(pad[:nq, :d], q) and not pad[nq:].any() and not pad[:, d:].any()


@pytest.mark.parametrize("nq,n,d,w,row_bytes,k,sms", [
    (0, 100, 512, None, 4, 0, 132), (5, 0, 512, None, 4, 0, 132), (5, 100, 0, None, 4, 0, 132),
    (5, 100, 512, None, 4, 0, 0), (5, 100, 512, W_COS, 4, 65, 132),
    (5, 100, 512, W_COS, 1, 10, 132), (5_000_000, 100, 512, None, 4, 0, 132)])
def test_shapes_the_kernels_cannot_take_raise(nq, n, d, w, row_bytes, k, sms):
    with pytest.raises(ValueError, match="f32 sweep"):
        fm.f32_sweep_plan(nq, n, d, w, row_bytes, k, sms=sms)


def test_the_plan_has_the_c_fields_in_their_order():
    names = [f.name for f in dataclasses.fields(fm.F32SweepPlan)]
    assert names == ["qw", "groups", "tile_rows", "passes", "resident", "q_rows", "q_pitch",
                     "box_dims", "boxes", "stage_boxes", "stages", "stage_bytes", "tma", "tiles",
                     "grid", "lists", "smem"]


# ---- the split-TF32 product -------------------------------------------------

def test_tf32_rounding_is_to_nearest_ties_away():
    one = 2.0 ** -10  # a TF32 unit at 1
    x = torch.tensor([1.0, 1 + one / 2, 1 + one / 4, 1 + 3 * one / 4, -(1 + one / 2),
                      2.0 ** -126, float("inf"), torch.finfo(torch.float32).max],
                     dtype=torch.float32)
    got = fm.tf32_rna(x)
    assert got[:6].tolist() == [1.0, 1 + one, 1.0, 1 + one, -(1 + one), 2.0 ** -126]
    assert got[6] == float("inf") and got[7] == float("inf")  # rounds past the largest TF32
    r = fm.tf32_rna(torch.randn(10_000, generator=torch.Generator().manual_seed(0)))
    assert not (r.view(torch.int32) & 0x1FFF).any()  # 10 stored mantissa bits


def test_tf32_split_keeps_all_but_2_to_the_minus_22():
    """hi + lo holds x to within 2^-22 of |x|: what the third product leaves
    out (lo * lo) is of that size."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(100_000).astype(np.float32))
    hi = fm.tf32_rna(x)
    lo = fm.tf32_rna(x - hi)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())


def _unit(rng, rows, d):
    a = rng.standard_normal((rows, d))
    return torch.from_numpy(a / np.linalg.norm(a, axis=1, keepdims=True)).to(torch.float32)


@pytest.mark.parametrize("d", [512, 768])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_products_hold_the_contract(d, seed):
    """On seeded unit rows and unit queries (the cosine is the product), the
    three TF32 products with sums restarted every 32 dims stay within the
    contract's 1e-5 of float64 (in fact within 1e-6); one TF32 product does
    not."""
    rng = np.random.default_rng(seed)
    q, g = _unit(rng, 64, d), _unit(rng, 4096, d)
    exact = q.double() @ g.double().t()
    split = (fm.split_tf32_dots(q, g).double() - exact).abs().max().item()
    single = (fm.split_tf32_dots(q, g, products=1).double() - exact).abs().max().item()
    assert split < 1e-6 < CONTRACT < single


@pytest.mark.parametrize("box", [32, 64])
def test_split_tf32_over_bf16_rows_needs_two_products(box):
    """A bf16 row is a TF32 value (its lo part is 0), so over bf16 rows the
    product q_lo * g + q_hi * g is the whole of the split's three."""
    rng = np.random.default_rng(3)
    q = _unit(rng, 16, 768)
    g = _unit(rng, 512, 768).to(torch.bfloat16).to(torch.float32)
    assert torch.equal(fm.tf32_rna(g), g)
    exact = q.double() @ g.double().t()
    assert (fm.split_tf32_dots(q, g, box).double() - exact).abs().max().item() < 1e-6
