"""The plain index sweeps: the scores that a served search answer is judged
by, over the gallery rows the benchmark made and handed to the program.

It imports nothing of the program and works out again what the program's
index derives from the rows: the int8 rows and their norm-preserving
per-row scales (the index's insert formula: absmax / 127 in f32, the rows
divided by it and rounded half to even, scale = ||row|| / ||int8 row||), the
query's rounding to bf16 where the tier rounds it, and the bf16 rounding
points of the weighted int8 score. The scores of the rows that matter are
taken in float64.

A reference top-k runs in two passes: a screening pass over every row, in
f32 (TF32 off), keeps `k + MARGIN` candidates per query; the candidates and
the rows the program served are then scored again in float64. The margin
holds the true top-k wherever the screening pass's f32 error (about 1e-6)
is smaller than the gap between the k-th and the (k + MARGIN)-th score.

`levels` is the row grid of the quantized tier: 127 (int8, the tier's
precision); the control passes 7 (int4). `tf32` runs the f32 tier's product
in TF32, the control one precision below full f32.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.clip import full_f32

MARGIN = 32
BLOCK_ROWS = 1 << 18


def quantize_rows(unit: torch.Tensor, levels: int = 127):
    """f32 unit rows -> (integer values as f32, f32 norm-preserving scales)."""
    t = unit.abs()
    absmax = torch.clamp(t.amax(1), min=1e-12)
    grid = absmax / torch.full_like(absmax, float(levels))
    q = torch.clamp(torch.round(unit / grid[:, None]), -levels, levels)
    qnorm = torch.linalg.vector_norm(q, dim=1)
    unorm = torch.linalg.vector_norm(unit, dim=1)
    return q, unorm / torch.where(qnorm > 0, qnorm, torch.ones_like(qnorm))


def unit(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(n > 0, q / torch.where(n > 0, n, torch.ones_like(n)), torch.zeros_like(q))


class Scorer:
    """Scores of queries against gallery rows on one tier, for one metric
    ("cosine_similarity", or "optimized_similarity" with `weights`)."""

    def __init__(self, tier: str, metric: str, weights=None, levels: int = 127,
                 tf32: bool = False):
        self.tier, self.metric, self.levels, self.tf32 = tier, metric, levels, tf32
        self.w = weights

    def _cos_query(self, emb: torch.Tensor) -> torch.Tensor:
        u = unit(emb.double())
        if self.tier == "float32":
            return u
        return u.float().to(torch.bfloat16).double()  # the tier's bf16 query

    def screen(self, emb: torch.Tensor, rows: torch.Tensor, mags: torch.Tensor) -> torch.Tensor:
        """(S, D) query embeddings x (n, D) f32 unit rows -> (S, n) f32 scores."""
        return self._scores(emb, rows, mags, torch.float32)

    def exact(self, emb: torch.Tensor, rows: torch.Tensor, mags: torch.Tensor) -> torch.Tensor:
        """(D,) query x (m, D) rows -> (m,) float64 scores."""
        return self._scores(emb[None], rows, mags, torch.float64)[0]

    def _scores(self, emb, rows, mags, dt):
        if self.tier == "float32":
            q = self._cos_query(emb).to(dt)
            with full_f32(self.tf32):
                return q @ rows.to(dt).t()
        g, sc = quantize_rows(rows, self.levels)
        if self.metric == "cosine_similarity":
            return (self._cos_query(emb).to(dt) @ g.to(dt).t()) * sc.to(dt)
        return self._weighted(emb, g, sc, mags, dt)

    def _weighted(self, emb, g, sc, m, dt):
        """The int8 tier's weighted score, by the tier's definition: the angle
        and the Gram-form L2 off the bf16-rounded query's products with the
        integer rows; L1 and Linf over bf16 differences between the bf16
        reconstructed rows (integer x bf16(scale x magnitude)) and the bf16
        query; the magnitude term; each term at its weight."""
        w_angle, w_l1, w_l2, w_inf, w_mag = self.w
        q = emb.float()
        qn = torch.linalg.vector_norm(q.double(), dim=-1, keepdim=True).to(dt)
        q16 = q.to(torch.bfloat16)
        d = q.shape[-1]
        mm = m.to(dt)[None, :]
        udots = (q16.to(dt) @ g.to(dt).t()) * sc.to(dt)[None, :]
        s = torch.zeros_like(udots)
        if w_angle:
            s += w_angle * udots / qn
        if w_l2:
            s -= w_l2 * torch.sqrt(torch.clamp(mm * mm - 2.0 * mm * udots + qn * qn, min=0.0)) / (
                d ** 0.5)
        if w_l1 or w_inf:
            rec = g.to(torch.bfloat16) * (sc * m).to(torch.bfloat16)[:, None]
            step = max(1, (1 << 26) // max(1, q.shape[0] * d))
            for lo in range(0, g.shape[0], step):
                ad = torch.abs(rec[None, lo: lo + step] - q16[:, None, :])
                if w_l1:
                    s[:, lo: lo + step] -= w_l1 * ad.to(dt).sum(-1) / d
                if w_inf:
                    s[:, lo: lo + step] -= w_inf * ad.amax(-1).to(dt)
        if w_mag:
            s -= w_mag * torch.abs(mm - qn)
        return s


def sweep_topk(scorer: Scorer, embs: torch.Tensor, host_rows: np.ndarray,
               host_mags: np.ndarray, depth: int, device) -> tuple:
    """The screening pass: each query's best `depth` rows by the scorer's f32
    (or, for the TF32 control, TF32) scores over the whole gallery, read from
    the benchmark's host copy `BLOCK_ROWS` at a time: (scores (S, depth) f32
    best first, row ids (S, depth)) as numpy."""
    s = embs.shape[0]
    best_v = torch.full((s, 0), float("-inf"), device=device)
    best_i = torch.zeros((s, 0), dtype=torch.int64, device=device)
    n = host_rows.shape[0]
    for lo in range(0, n, BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, n)
        rows = torch.from_numpy(host_rows[lo:hi]).to(device)
        mags = torch.from_numpy(host_mags[lo:hi]).to(device)
        v, i = torch.topk(scorer.screen(embs, rows, mags), min(depth, hi - lo), dim=1)
        best_v = torch.cat([best_v, v.float()], 1)
        best_i = torch.cat([best_i, i + lo], 1)
        best_v, order = torch.topk(best_v, min(depth, best_v.shape[1]), dim=1)
        best_i = torch.gather(best_i, 1, order)
    return best_v.cpu().numpy(), best_i.cpu().numpy()


def reference_topk(scorer: Scorer, embs: torch.Tensor, host_rows: np.ndarray,
                   host_mags: np.ndarray, k: int, device) -> tuple:
    """The reference's best k rows per query over the whole gallery:
    (float64 scores (S, k) best first, row ids (S, k)): the screening pass's
    k + MARGIN candidates scored again in float64, ties by ascending row."""
    _, cand = sweep_topk(scorer, embs, host_rows, host_mags, k + MARGIN, device)
    s = embs.shape[0]
    out_v = np.zeros((s, k))
    out_i = np.zeros((s, k), np.int64)
    for r in range(s):
        ids = np.unique(cand[r])
        ex = exact_scores(scorer, embs[r], host_rows, host_mags, ids, device)
        order = np.lexsort((ids, -ex))[:k]
        out_v[r], out_i[r] = ex[order], ids[order]
    return out_v, out_i


def exact_scores(scorer: Scorer, emb: torch.Tensor, host_rows: np.ndarray,
                 host_mags: np.ndarray, ids: np.ndarray, device) -> np.ndarray:
    """float64 scores of one query against the gallery rows `ids`."""
    rows = torch.from_numpy(host_rows[ids]).to(device)
    mags = torch.from_numpy(host_mags[ids]).to(device)
    return scorer.exact(emb, rows, mags).cpu().numpy()
