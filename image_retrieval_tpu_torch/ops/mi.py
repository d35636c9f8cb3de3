"""Mutual information, digit-exact vs sklearn.metrics.mutual_info_score —
port of ``image_retrieval_tpu/ops/mi.py``.

The reference computes MI between binned distances and relationship labels
(reference mi_analysis.py:348, :423, :557, :1508, :1616) using
mutual_info_score, which is contingency-table MI in *nats* (natural log),
even though the reference reports the numbers as "bits". We keep the same
units (and labeling) for parity.

  MI = sum_ij  (n_ij / N) * (log n_ij - log a_i - log b_j + log N)

The host float64 functions (copied from the JAX package) are canonical for
reported numbers; `mutual_info_uniform` evaluates a whole weight grid on a
device in one call, where the reference loops over combinations.
"""

from __future__ import annotations

import numpy as np
import torch

from image_retrieval_tpu_torch.ops.binning import discretize, discretize_uniform


def mutual_info_binned(x_binned: np.ndarray, y: np.ndarray) -> float:
    """MI between two already-discrete label vectors (float64, host).

    Matches sklearn.metrics.mutual_info_score(labels_true=x_binned,
    labels_pred=y) to the digit."""
    x_binned = np.asarray(x_binned).ravel()
    y = np.asarray(y).ravel()
    assert x_binned.shape == y.shape
    n = x_binned.shape[0]
    if n == 0:
        return 0.0
    _, xi = np.unique(x_binned, return_inverse=True)
    _, yi = np.unique(y, return_inverse=True)
    nx = xi.max() + 1
    ny = yi.max() + 1
    contingency = np.zeros((nx, ny), dtype=np.int64)
    np.add.at(contingency, (xi, yi), 1)
    nzx, nzy = np.nonzero(contingency)
    nz_val = contingency[nzx, nzy].astype(np.float64)
    pi = contingency.sum(axis=1).astype(np.float64)
    pj = contingency.sum(axis=0).astype(np.float64)
    log_nz = np.log(nz_val)
    contingency_sum = float(n)
    outer = pi[nzx] * pj[nzy]
    log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
    mi = (
        nz_val / contingency_sum * (log_nz - np.log(contingency_sum))
        + nz_val / contingency_sum * log_outer
    )
    # sklearn zeroes terms where |mi| < eps against accidental -0 noise,
    # then clips the sum at 0.
    mi = np.where(np.abs(mi) < np.finfo(np.float64).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def mutual_info_from_labels(
    values: np.ndarray, labels: np.ndarray, n_bins: int, strategy: str = "uniform"
) -> float:
    """Bin `values` then compute MI vs `labels` — the reference's
    KBinsDiscretizer + mutual_info_score pipeline (mi_analysis.py:344-348)."""
    values = np.asarray(values, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    # NaN filtering as in reference mi_analysis.py:330-332.
    valid = ~np.isnan(values)
    values, labels = values[valid], labels[valid]
    if values.size == 0:
        return 0.0
    binned = discretize(values, n_bins, strategy)
    return mutual_info_binned(binned, labels)


# ---------------------------------------------------------------------------
# Device versions (f32, batched over leading axes).
# ---------------------------------------------------------------------------


def _mi_binned(xb: torch.Tensor, y: torch.Tensor, n_x: int, n_y: int) -> torch.Tensor:
    """MI (nats) per row from int bins xb (C, P) in [0, n_x) and labels y
    (P,) in [0, n_y): (C,) f32. The contingency tables are counted by one
    index_add_ of f32 ones (exact below 2^24 pairs); the log is guarded where
    a cell is empty (it contributes 0) and the sum clipped at 0, as JAX's
    _mi_binned_jax."""
    c_rows, p = xb.shape
    cells = n_x * n_y
    flat = xb.long() * n_y + y.long()[None, :]
    flat = flat + torch.arange(c_rows, device=xb.device)[:, None] * cells
    ones = torch.ones(c_rows * p, dtype=torch.float32, device=xb.device)
    counts = torch.zeros(c_rows * cells, dtype=torch.float32, device=xb.device)
    c = counts.index_add_(0, flat.reshape(-1), ones).view(c_rows, n_x, n_y)
    n = c.sum((1, 2), keepdim=True)
    pi = c.sum(2, keepdim=True)
    pj = c.sum(1, keepdim=True)
    p_xy = c / n
    ratio = torch.where(c > 0, c * n / (pi * pj), 1.0)
    mi = (p_xy * torch.log(ratio)).sum((1, 2))
    return torch.clamp(mi, min=0.0)


def mutual_info_uniform(
    values: torch.Tensor, labels: torch.Tensor, n_bins: int, n_labels: int
) -> torch.Tensor:
    """Uniform-binned MI on `values`' device. `values`: (..., P) f32;
    `labels`: (P,) ints in [0, n_labels). Returns (...) f32: one call
    evaluates a whole weight grid, replacing the reference's
    per-combination Python loop (mi_analysis.py:487-498, :1345-1359)."""
    lead = values.shape[:-1]
    binned = discretize_uniform(values, n_bins).reshape(-1, values.shape[-1])
    mi = _mi_binned(binned, labels.to(values.device), n_bins, n_labels)
    return mi.reshape(lead)
