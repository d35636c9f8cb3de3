"""Capacity and latency planner: the index tier for a corpus size — the port
of ``image_retrieval_tpu/index/plan.py``.

The port has the JAX package's storage and search tiers (resident f32 /
bf16 / int8 / int4-packed, streamed exact, offloaded IVF). ``plan_index``
walks the JAX planner's decision tree, returns the same ``IndexConfig`` /
``SearchConfig`` for the same inputs, and estimates from this card's own
readings.

Reference analog: the reference runs one Milvus configuration for every
corpus (IVF_FLAT nlist=1024 / nprobe=10, reference
ImageEmbeddingSystem.py:56-61) and leaves scaling to the Milvus server.

The card's constants, measured by ``chip_smoke.py --ivf`` (phase 11) on an
NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md section 5 gives
the runs; the whole script's phase 11 fails when one is more than 25% off):
  * USABLE_HBM_BYTES: the device memory a gallery may take, the card's free
    memory plus what the process's caching allocator holds, read at the
    start of phase 11 alone (``--ivf``), less SEARCH_HEADROOM_BYTES for the
    search planes and the encoder.
  * SINGLE_Q_MS_1M: the card's time for one cosine query over 2^20 x 512
    resident rows in each storage type (torch.profiler's device time, the
    p50 over five queries); two runs on two machines read f32 0.65-0.86
    ms, bf16 2.66-2.88, int8 2.10-2.60, int4 0.28-0.36, and each value is
    their geometric mean. A user waits longer by the host's launches and
    synchronizations: the host clock's p50 read f32 1.20-1.63 ms, bf16
    3.51-4.87, int8 3.14-3.88 and int4 1.25-2.36 over six runs, a spread no
    25% check can hold, so the planner's estimate is the card's part.
  * SWEEP_GBPS: the resident int8 tier's batched sweep over 2^23 x 512 rows
    at Q = 64, (D + 4) bytes a row over its p50 time.
  * PCIE_GBPS: one 2^22 x 512 int8 chunk's upload from pinned host rows
    (CUDA events), the rate the streamed tier and the offloaded IVF move
    rows at.
RECALL_AT_10 and IVF_RECALL_CLUSTERED are properties of the quantization
and of the data, which the port reproduces bit for bit (host quantization
equal to the JAX package's): they keep the JAX package's values (its
index/plan.py, recall@10 against the f32 oracle), and phase 11 prints what
it reads on the card beside them. The approximate selector's factors are
1.0: off a TPU ``approx_select`` runs the exact selector.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from image_retrieval_tpu_torch.config import IndexConfig, SearchConfig

# --- the card's constants (sources in the module docstring) ---------------
SEARCH_HEADROOM_BYTES = 8 << 30
USABLE_HBM_BYTES = int(70.44 * (1 << 30))
SWEEP_GBPS = 109.5  # the resident int8 sweep at Q = 64, 2^23 x 512 rows
SINGLE_Q_MS_1M = {"float32": 0.75, "bfloat16": 2.77, "int8": 2.34, "int4": 0.32}
PCIE_GBPS = 46.1  # pinned host rows -> the card
# --- properties of the quantization and the data (the JAX package's) ------
RECALL_AT_10 = {"float32": 1.0, "bfloat16": 0.999, "int8": 0.984,
                "int4": 0.983}
IVF_RECALL_CLUSTERED = 0.958
# The approximate selector: its recall against the exact selection and its
# batched speed-up (the JAX package's 0.9984 and 5.8 on a TPU). Off a TPU
# approx_select runs the exact selector.
APPROX_SELECT_RECALL = 1.0
APPROX_SELECT_SPEEDUP = 1.0


def _bytes_per_row(dtype: str, dim: int) -> int:
    """Device-resident bytes per gallery row, including per-row scales."""
    if dtype == "float32":
        return 4 * dim
    if dtype == "bfloat16":
        return 2 * dim
    if dtype == "int8":
        return dim + 4
    if dtype == "int4":
        return dim // 2 + 4
    raise ValueError(f"unknown dtype {dtype!r}")


@dataclasses.dataclass(frozen=True)
class IndexPlan:
    """A concrete index recommendation with its estimates."""

    tier: str                     # e.g. "resident-int8", "streamed-exact"
    index: IndexConfig
    search: SearchConfig
    n_devices: int
    rows_per_device: int
    est_hbm_bytes_per_device: int
    est_single_query_ms: Optional[float]
    est_batched_ms_per_query: Optional[float]
    expected_recall_at_10: float
    host_ram_bytes: int           # host-side copies the tier requires
    rationale: List[str]

    def describe(self) -> str:
        lines = [f"tier: {self.tier}",
                 f"devices: {self.n_devices} "
                 f"({self.rows_per_device:,} rows/device, "
                 f"{self.est_hbm_bytes_per_device / (1 << 30):.2f} GiB "
                 f"HBM/device)"]
        if self.est_single_query_ms is not None:
            lines.append(
                f"est single-query device time: {self.est_single_query_ms:.2f} ms")
        if self.est_batched_ms_per_query is not None:
            lines.append(f"est batched: "
                         f"{self.est_batched_ms_per_query:.3f} ms/query")
        lines.append(
            f"expected recall@10: {self.expected_recall_at_10:.3f}")
        if self.host_ram_bytes:
            lines.append(f"host RAM needed: "
                         f"{self.host_ram_bytes / (1 << 30):.2f} GiB")
        lines.append(f"config: dtype={self.index.dtype}"
                     + (f", stream_threshold_bytes="
                        f"{self.index.stream_threshold_bytes}"
                        if self.index.stream_threshold_bytes else "")
                     + (f", ann={self.search.ann}"
                        f" nlist={self.search.nlist}"
                        f" nprobe={self.search.nprobe}"
                        if self.search.ann != "exact" else ""))
        lines += [f"  - {r}" for r in self.rationale]
        return "\n".join(lines)


def _resident_plan(dtype: str, n_rows: int, dim: int, n_devices: int,
                   rows_per_dev: int, rationale: List[str]) -> IndexPlan:
    rows_m = rows_per_dev / 1e6
    bpr = _bytes_per_row(dtype, dim)
    # single query: the 2^20-row reading, linear in resident rows past it
    single = SINGLE_Q_MS_1M[dtype] * max(rows_m, 1.0) * (dim / 512.0)
    # batched: the whole gallery at the measured sweep rate, over a
    # 64-query batch
    batched = rows_per_dev * bpr / (SWEEP_GBPS * 1e9) * 1e3 / 64
    host = 0
    idx = IndexConfig(embedding_dim=dim, dtype=dtype)
    if dtype == "int4":
        # the exact rerank reads the int8 copy from host RAM
        host = rows_per_dev * n_devices * (dim + 4)
        rationale.append(
            "int4 keeps an int8 copy in host RAM as the exact-rerank "
            "source (C rows/query gathered in phase 2)")
    return IndexPlan(
        tier=f"resident-{dtype}", index=idx, search=SearchConfig(),
        n_devices=n_devices, rows_per_device=rows_per_dev,
        est_hbm_bytes_per_device=rows_per_dev * bpr,
        est_single_query_ms=round(single, 2),
        est_batched_ms_per_query=round(batched, 4),
        expected_recall_at_10=RECALL_AT_10[dtype],
        host_ram_bytes=host, rationale=rationale)


def plan_index(
    n_rows: int,
    dim: int = 512,
    n_devices: int = 1,
    recall_floor: float = 0.98,
    clustered: bool = False,
    exact_scores: bool = False,
    usable_hbm_bytes: Optional[int] = None,
    host_to_device_gbps: Optional[float] = None,
) -> IndexPlan:
    """Pick the tier for a corpus.

    Args:
      n_rows / dim: corpus shape.
      n_devices: devices the rows shard over (the plan sizes per device;
        the port serves one).
      recall_floor: minimum acceptable recall@10 vs the f32 oracle.
        1.0 forces float32/bfloat16-exact tiers; the default 0.98 admits
        int8 (0.984) and int4 two-phase (0.983).
      clustered: the corpus has cluster structure (e.g. category datasets).
        Gates IVF tiers: on i.i.d. data IVF recall collapses and is never
        auto-picked.
      exact_scores: require bit-faithful f32 scores (not just top-k
        recall), e.g. for MI analysis over raw similarity values.
      usable_hbm_bytes: per-device gallery budget (default
        USABLE_HBM_BYTES).
      host_to_device_gbps: link rate for the beyond-HBM estimates (default
        PCIE_GBPS).

    Returns an IndexPlan; ``plan.index`` / ``plan.search`` are ready to
    pass to ``ShardedVectorIndex`` / the searcher.
    """
    if usable_hbm_bytes is None:
        usable_hbm_bytes = USABLE_HBM_BYTES
    if host_to_device_gbps is None:
        host_to_device_gbps = PCIE_GBPS
    if n_rows <= 0:
        raise ValueError("n_rows must be positive")
    rows_per_dev = math.ceil(n_rows / n_devices)

    def fits(dtype: str) -> bool:
        return rows_per_dev * _bytes_per_row(dtype, dim) <= usable_hbm_bytes

    # dtype preference under the recall floor, fastest first
    if exact_scores or recall_floor > RECALL_AT_10["bfloat16"]:
        ladder = ["float32"]
    elif recall_floor > RECALL_AT_10["int8"]:
        ladder = ["bfloat16", "float32"]
    elif recall_floor > RECALL_AT_10["int4"]:
        ladder = ["int8", "bfloat16", "float32"]
    else:
        ladder = ["int8", "int4", "bfloat16", "float32"]

    # the int4 latency tier: packed screen + int8 rows both resident (1.5x
    # int8's bytes), the exact rerank gathering on the device. The screen
    # sweeps half the int8 bytes, so past ~4M rows per device it is chosen
    # over the int8 sweep. Needs dim % 512 == 0.
    latency_bpr = dim // 2 + dim + 8  # packed + int8 rows + both scales
    if ("int4" in ladder and dim % 512 == 0
            and rows_per_dev >= 4_000_000
            and rows_per_dev * latency_bpr <= usable_hbm_bytes):
        return IndexPlan(
            tier="resident-int4-latency",
            index=IndexConfig(embedding_dim=dim, dtype="int4",
                              rerank_device=True),
            search=SearchConfig(),
            n_devices=n_devices, rows_per_device=rows_per_dev,
            est_hbm_bytes_per_device=rows_per_dev * latency_bpr,
            est_single_query_ms=round(
                SINGLE_Q_MS_1M["int4"] * max(rows_per_dev / 1e6, 1.0)
                * (dim / 512.0), 2),
            est_batched_ms_per_query=round(
                rows_per_dev * (dim // 2 + 4) / (SWEEP_GBPS * 1e9)
                * 1e3 / 64, 4),
            expected_recall_at_10=RECALL_AT_10["int4"],
            host_ram_bytes=0,
            rationale=[
                "int4-latency: the packed screen sweeps half the int8 bytes "
                "and the exact int8 rerank gathers on the device "
                "(rerank_device); costs 1.5x int8's device memory and "
                "returns int8 scores for every row the screen keeps; the "
                f"estimates are the card's time for one int4 query "
                f"({SINGLE_Q_MS_1M['int4']:.2f} ms at 2^20 rows) and the "
                f"sweep rate {SWEEP_GBPS:.0f} GB/s (chip_smoke.py phase 11, "
                "NVIDIA H100 80GB HBM3, 700.00 W)"])

    for dtype in ladder:
        if fits(dtype):
            rationale = [
                f"{dtype} is the fastest tier meeting "
                f"recall_floor={recall_floor} "
                f"(recall@10 {RECALL_AT_10[dtype]:.3f}) that fits "
                f"{rows_per_dev:,} rows/device in "
                f"{usable_hbm_bytes / (1 << 30):.1f} GiB of device memory"]
            # the JAX planner turns approx_select on for multi-M resident
            # plans whose floor admits the selector's recall
            approx_on = (dtype in ("int8", "bfloat16", "float32")
                         and not exact_scores
                         and rows_per_dev >= 4_000_000
                         and recall_floor <= RECALL_AT_10[dtype] * APPROX_SELECT_RECALL)
            if approx_on:
                rationale.append(
                    "approx_select enabled (as the JAX planner does); on this "
                    "card it runs the exact selector: recall and latency are "
                    "the exact selection's")
            if dtype == "float32" and not exact_scores and len(ladder) == 1:
                rationale.append(
                    "recall_floor > 0.999 forces the f32 oracle tier")
            if exact_scores:
                rationale.append("exact_scores=True forces f32 (raw "
                                 "similarity values, e.g. MI analysis)")
            plan = _resident_plan(dtype, n_rows, dim, n_devices,
                                  rows_per_dev, rationale)
            if approx_on:
                plan.index.approx_select = True
                plan = dataclasses.replace(
                    plan,
                    expected_recall_at_10=round(
                        RECALL_AT_10[dtype] * APPROX_SELECT_RECALL, 4),
                    est_batched_ms_per_query=round(
                        plan.est_batched_ms_per_query / APPROX_SELECT_SPEEDUP, 4),
                )
            return plan

    # Nothing fits resident: first say how many devices would make the best
    # resident tier fit
    best = ladder[0]
    need = math.ceil(n_rows * _bytes_per_row(best, dim) / usable_hbm_bytes)
    shard_note = (
        f"preferred scale-out: shard over {need} devices "
        f"(resident-{best}, top-k merge; multi-device is ROADMAP.md queue 1 "
        f"item 10); only {n_devices} available, falling back to beyond-HBM "
        "tiers")

    gallery_bytes = n_rows * dim  # int8 body, the streamed/IVF store
    if clustered and recall_floor <= IVF_RECALL_CLUSTERED:
        from image_retrieval_tpu_torch.index.ivf import recommended_ivf

        op = recommended_ivf(n_rows)
        nlist, nprobe = op if op else (0, 0)
        idx = IndexConfig(embedding_dim=dim, dtype="int8",
                          stream_threshold_bytes=usable_hbm_bytes)
        # transfer per 64-query batch: at most nprobe * 64 unique slabs of
        # ~(N / nlist) rows
        slab_bytes = math.ceil(n_rows / max(nlist, 1)) * dim
        batch_bytes = min(nprobe * 64, nlist) * slab_bytes
        est = batch_bytes / (host_to_device_gbps * 1e9) * 1e3 / 64
        return IndexPlan(
            tier="ivf-offload", index=idx,
            search=SearchConfig(ann="ivf", nlist=nlist, nprobe=nprobe),
            n_devices=n_devices, rows_per_device=0,
            est_hbm_bytes_per_device=batch_bytes,
            est_single_query_ms=None,
            est_batched_ms_per_query=round(est, 4),
            expected_recall_at_10=IVF_RECALL_CLUSTERED,
            host_ram_bytes=gallery_bytes + 4 * n_rows,
            rationale=[
                shard_note,
                "clustered corpus beyond device memory: the offloaded IVF "
                "moves only the batch's probed slabs (chip_smoke.py phase 11 "
                "measures its recall and bytes at 2^23 rows); the estimate "
                "is the worst-case transfer at "
                f"{host_to_device_gbps:.0f} GB/s"])

    # streamed exact sweep: int8 recall, transfer-bound
    idx = IndexConfig(embedding_dim=dim, dtype="int8",
                      stream_threshold_bytes=usable_hbm_bytes)
    sweep_s = gallery_bytes / (host_to_device_gbps * 1e9)
    return IndexPlan(
        tier="streamed-exact", index=idx, search=SearchConfig(),
        n_devices=n_devices, rows_per_device=0,
        est_hbm_bytes_per_device=0,
        est_single_query_ms=None,
        est_batched_ms_per_query=round(sweep_s / 64 * 1e3, 3),
        expected_recall_at_10=RECALL_AT_10["int8"],
        host_ram_bytes=gallery_bytes + 4 * n_rows,
        rationale=[
            shard_note,
            ("unclustered corpus (or recall_floor above the IVF point): "
             if not clustered else
             f"recall_floor={recall_floor} exceeds the IVF recall "
             f"{IVF_RECALL_CLUSTERED}: ")
            + "the streamed exact sweep is bound by the upload (chip_smoke.py "
              "phase 10 measured it within 8-18% of expected_sweep_seconds); "
              f"the estimate assumes {host_to_device_gbps:.0f} GB/s and a "
              "64-query batch amortizing each sweep"])
