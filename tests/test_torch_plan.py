"""The port's tier planner (index/plan.py) against the JAX package's.

With the port's constants set to the JAX module's values (read from the JAX
module here, and the approximate selector's 0.9984 and 5.8 that the JAX
planner writes inline), plan_index returns the JAX planner's tier, configs
and estimates over a grid of corpora. With the card's own constants, the
decision tree's crossovers sit where those constants put them; the tests
derive the row counts from the constants, so they follow a new reading.
"""

import dataclasses
import math

import pytest

from image_retrieval_tpu.index import plan as jplan
from image_retrieval_tpu_torch.config import IndexConfig, SearchConfig
from image_retrieval_tpu_torch.index import plan as pplan
from image_retrieval_tpu_torch.index.ivf import recommended_ivf
from image_retrieval_tpu_torch.index.plan import IndexPlan, plan_index

# the JAX planner's inline approximate-selector factors (its plan_index)
JAX_APPROX_RECALL, JAX_APPROX_SPEEDUP = 0.9984, 5.8
INT8_WALL = pplan.USABLE_HBM_BYTES // (512 + 4)  # int8 512-d rows that fit one card
INT4_WALL = pplan.USABLE_HBM_BYTES // (256 + 4)


@pytest.fixture
def jax_constants(monkeypatch):
    for name in ("USABLE_HBM_BYTES", "SWEEP_GBPS", "SINGLE_Q_MS_1M", "RECALL_AT_10",
                 "IVF_RECALL_CLUSTERED", "PCIE_GBPS"):
        monkeypatch.setattr(pplan, name, getattr(jplan, name))
    monkeypatch.setattr(pplan, "APPROX_SELECT_RECALL", JAX_APPROX_RECALL)
    monkeypatch.setattr(pplan, "APPROX_SELECT_SPEEDUP", JAX_APPROX_SPEEDUP)


def same_plan(got, want):
    assert got.tier == want.tier
    assert dataclasses.asdict(got.index) == dataclasses.asdict(want.index)
    assert dataclasses.asdict(got.search) == dataclasses.asdict(want.search)
    for f in ("n_devices", "rows_per_device", "est_hbm_bytes_per_device",
              "est_single_query_ms", "est_batched_ms_per_query", "expected_recall_at_10",
              "host_ram_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.rationale) == len(want.rationale)


@pytest.mark.parametrize("n_rows", [1, 100_000, 1 << 20, 4_000_000, 8 << 20, 20_000_000,
                                    40_000_000, 1 << 26, 80_000_000, 1 << 30])
@pytest.mark.parametrize("dim", [256, 512, 1024])
def test_plan_index_matches_jax_with_its_constants(jax_constants, n_rows, dim):
    for n_devices in (1, 8):
        for recall_floor in (0.5, 0.95, 0.97, 0.9835, 0.98, 0.99, 1.0):
            for clustered in (False, True):
                for exact_scores in (False, True):
                    kw = dict(n_rows=n_rows, dim=dim, n_devices=n_devices,
                              recall_floor=recall_floor, clustered=clustered,
                              exact_scores=exact_scores)
                    same_plan(plan_index(**kw), jplan.plan_index(**kw))
    kw = dict(usable_hbm_bytes=4 << 30, host_to_device_gbps=3.0)
    same_plan(plan_index(n_rows, dim, clustered=True, recall_floor=0.9, **kw),
              jplan.plan_index(n_rows, dim, clustered=True, recall_floor=0.9, **kw))


def test_bytes_per_row_matches_jax():
    for dtype in ("float32", "bfloat16", "int8", "int4"):
        for dim in (64, 512, 768):
            assert pplan._bytes_per_row(dtype, dim) == jplan._bytes_per_row(dtype, dim)
    with pytest.raises(ValueError):
        pplan._bytes_per_row("int2", 512)


def test_describe_renders_like_jax(jax_constants):
    for n in (1_000_000, 40_000_000, 1 << 28):
        got, want = plan_index(n, clustered=True, recall_floor=0.95), jplan.plan_index(
            n, clustered=True, recall_floor=0.95)
        # the port's single-query estimate is the card's time, and says so
        head = got.describe().split("\n  - ")[0].replace(
            "est single-query device time:", "est single-query p50:")
        assert head == want.describe().split("\n  - ")[0]


# -- the card's constants -------------------------------------------------------


def test_constants_are_the_cards():
    """No TPU value: the memory budget is the H100's (tens of GiB), and the
    approximate selector changes nothing off a TPU."""
    assert pplan.USABLE_HBM_BYTES > 4 * jplan.USABLE_HBM_BYTES
    assert pplan.APPROX_SELECT_RECALL == pplan.APPROX_SELECT_SPEEDUP == 1.0
    assert set(pplan.SINGLE_Q_MS_1M) == set(jplan.SINGLE_Q_MS_1M)
    assert pplan.RECALL_AT_10 == jplan.RECALL_AT_10
    assert pplan.IVF_RECALL_CLUSTERED == jplan.IVF_RECALL_CLUSTERED


def test_small_corpus_picks_resident_int8():
    plan = plan_index(1_000_000)
    assert plan.tier == "resident-int8" and plan.index.dtype == "int8"
    assert plan.search.ann == "exact" and plan.expected_recall_at_10 >= 0.98
    assert plan.est_single_query_ms == round(pplan.SINGLE_Q_MS_1M["int8"], 2)
    assert plan.host_ram_bytes == 0


def test_recall_floor_one_forces_f32():
    plan = plan_index(1_000_000, recall_floor=1.0)
    assert plan.tier == "resident-float32" and plan.expected_recall_at_10 == 1.0


def test_exact_scores_forces_f32_even_with_low_floor():
    plan = plan_index(1_000_000, recall_floor=0.5, exact_scores=True)
    assert plan.tier == "resident-float32"
    assert any("exact_scores" in r for r in plan.rationale)


def test_recall_between_int8_and_bf16_picks_bf16():
    assert plan_index(1_000_000, recall_floor=0.99).tier == "resident-bfloat16"


def test_int4_engages_past_the_int8_capacity_wall():
    n = INT8_WALL + 1_000_000  # int8 rows no longer fit; nibble-packed ones do
    plan = plan_index(n)
    assert plan.tier == "resident-int4" and plan.index.dtype == "int4"
    assert plan.est_hbm_bytes_per_device <= pplan.USABLE_HBM_BYTES
    assert plan.host_ram_bytes >= n * 512  # the int8 rerank copy in host RAM


def test_int4_skipped_when_floor_above_its_recall():
    plan = plan_index(INT8_WALL + 1_000_000, recall_floor=0.9835)
    assert plan.tier == "streamed-exact"
    assert plan.index.stream_threshold_bytes == pplan.USABLE_HBM_BYTES


def test_latency_tier_needs_room_and_scale():
    assert plan_index(1_000_000).tier == "resident-int8"  # below 4M rows/device
    assert plan_index(8_000_000, dim=256).tier == "resident-int8"  # dim % 512 != 0
    latency = plan_index(8_000_000)
    assert latency.tier == "resident-int4-latency" and latency.index.rerank_device
    # 1.5x int8's bytes no longer fit while int8 does -> int8
    n = int(pplan.USABLE_HBM_BYTES // (512 + 512 // 2 + 8)) + 1_000_000
    assert n < INT8_WALL and plan_index(n).tier == "resident-int8"


def test_sharding_keeps_huge_corpora_resident():
    plan = plan_index(80_000_000, n_devices=8)
    assert plan.rows_per_device == math.ceil(80_000_000 / 8)
    assert plan.tier == "resident-int4-latency"
    assert plan.est_hbm_bytes_per_device <= pplan.USABLE_HBM_BYTES


def test_beyond_hbm_clustered_picks_offloaded_ivf():
    n = 2 * INT4_WALL
    plan = plan_index(n, clustered=True, recall_floor=0.95)
    assert plan.tier == "ivf-offload" and plan.search.ann == "ivf"
    assert (plan.search.nlist, plan.search.nprobe) == recommended_ivf(n)
    assert plan.index.stream_threshold_bytes == pplan.USABLE_HBM_BYTES
    assert any("shard over" in r for r in plan.rationale)


def test_beyond_hbm_unclustered_streams_exact():
    plan = plan_index(2 * INT4_WALL, clustered=False, recall_floor=0.95)
    assert plan.tier == "streamed-exact" and plan.expected_recall_at_10 >= 0.95
    sweep_s = 2 * INT4_WALL * 512 / (pplan.PCIE_GBPS * 1e9)
    assert plan.est_batched_ms_per_query == round(sweep_s / 64 * 1e3, 3)


def test_clustered_but_high_floor_still_streams():
    assert plan_index(2 * INT4_WALL, clustered=True, recall_floor=0.97).tier == "streamed-exact"


def test_configs_are_constructible_types():
    plan = plan_index(5_000_000)
    assert isinstance(plan, IndexPlan)
    assert isinstance(plan.index, IndexConfig) and isinstance(plan.search, SearchConfig)
    assert plan.describe()


def test_dim_scales_capacity():
    n = INT8_WALL * 3 // 4
    assert plan_index(n, dim=512, recall_floor=0.9835).tier == "resident-int8"
    assert plan_index(n, dim=1024, recall_floor=0.9835).tier == "streamed-exact"


def test_rejects_nonpositive_rows():
    with pytest.raises(ValueError):
        plan_index(0)


def test_approx_select_flips_as_in_jax_and_changes_nothing():
    plan = plan_index(8_000_000, dim=256)
    assert plan.tier == "resident-int8" and plan.index.approx_select is True
    assert plan.expected_recall_at_10 == pplan.RECALL_AT_10["int8"]
    assert plan.est_batched_ms_per_query == pplan._resident_plan(
        "int8", 8_000_000, 256, 1, 8_000_000, []).est_batched_ms_per_query
    assert plan_index(1_000_000).index.approx_select is False
    # with the selector's factors at 1.0 every multi-M resident plan flips it
    bf16 = plan_index(8_000_000, dim=256, recall_floor=0.99)
    assert bf16.tier == "resident-bfloat16" and bf16.index.approx_select is True
    assert plan_index(8_000_000, dim=256, exact_scores=True,
                      recall_floor=0.5).index.approx_select is False


@pytest.mark.parametrize("rows", [1 << 20, 1 << 23, 1 << 25, 1 << 27])
def test_cli_plan_subcommand(capsys, rows):
    from image_retrieval_tpu_torch.app.cli import main

    assert main(["plan", "--rows", str(rows), "--clustered"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"tier: {plan_index(rows, clustered=True).tier}")
    assert main(["plan", "--rows", str(rows), "--link-gbps", "2", "--recall_floor", "0.9"]) == 0
    assert plan_index(rows, recall_floor=0.9, host_to_device_gbps=2.0).describe() in \
        capsys.readouterr().out
