"""The int4 tier's search collectives on one device.

Port of ``sharded_int4_screen_topk`` and ``sharded_int4_two_phase_topk``
(``image_retrieval_tpu/parallel/collectives.py:398-562``) for a single shard:
the gallery is not split, so each function is its shard-local body followed
by the k-sized merge, which on one shard only restores the canonical order
(score, then ascending row index). Multi-device (a row-sharded gallery with
an NCCL merge) comes with ROADMAP.md queue 1 item 7.

The screen is ``ops/int4_screen.py::int4_screen_topc``: the Hopper kernel
on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from image_retrieval_tpu_torch.device import require_full_f32
from image_retrieval_tpu_torch.ops.int4 import unit_queries
from image_retrieval_tpu_torch.ops.int4_screen import int4_screen_topc
from image_retrieval_tpu_torch.ops.topk import exact_topk, two_key_topk


def sharded_int4_screen_topk(queries: torch.Tensor, packed: torch.Tensor,
                             valid: torch.Tensor, scales: torch.Tensor,
                             c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine screen over the nibble-packed gallery: top-min(c, N) per
    query of the int4 approximate scores. Queries are normalized with the
    zero-norm guard and cast to bf16. Rows where `valid` is False score
    -inf and surface only as padding. Returns (scores (Q, cc) f32, row
    indices (Q, cc) int64). One device; multi-device comes with ROADMAP.md
    queue 1 item 7."""
    cc = min(c, packed.shape[0])
    qu = unit_queries(queries).to(torch.bfloat16)
    return int4_screen_topc(qu, packed, scales, valid, cc)


def sharded_int4_two_phase_topk(queries: torch.Tensor, packed: torch.Tensor,
                                valid: torch.Tensor, scales: torch.Tensor,
                                rows8: torch.Tensor, scales8: torch.Tensor,
                                c: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int4 two-phase search with the int8 rows on the device
    (IndexConfig.rerank_device): screen top-cc, gather the candidates'
    int8 rows on the device, rerank exactly (bf16-rounded unit query x int8
    rows, f32 sums, x the int8 scale; screen padding -inf), top-kk with the
    lowest candidate position first among ties, then the merge's canonical
    order. Returns (scores (Q, kk) f32, row indices (Q, kk) int64). One
    device; multi-device comes with ROADMAP.md queue 1 item 7."""
    require_full_f32(rows8.device)
    cc = min(c, packed.shape[0])
    kk = min(k, cc)
    qu = unit_queries(queries).to(torch.bfloat16)
    sv, sidx = int4_screen_topc(qu, packed, scales, valid, cc)
    cand = rows8[sidx].to(torch.float32)  # (Q, cc, D)
    ex = torch.bmm(cand, qu.to(torch.float32)[:, :, None])[..., 0] * scales8[sidx]
    ex = torch.where(torch.isfinite(sv), ex, float("-inf"))
    vals, pos = exact_topk(ex, kk)
    return two_key_topk(vals, torch.gather(sidx, 1, pos), k, True)
