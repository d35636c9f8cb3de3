"""KBinsDiscretizer-compatible binning — port of ``image_retrieval_tpu/ops/binning.py``.

The reference discretizes distance vectors with
sklearn.preprocessing.KBinsDiscretizer(n_bins, encode='ordinal',
strategy='uniform'|'quantile') before computing MI
(reference mi_analysis.py:344-345, :419-420, :553-554, :1504, :1613).

MI numerical parity requires replicating sklearn's semantics exactly:
  * uniform : edges = linspace(min, max, n_bins+1)
  * quantile: edges = percentile(x, linspace(0, 100, n_bins+1)), then edges
              closer than 1e-8 are merged (sklearn _discretization.py)
  * assignment: searchsorted(edges[1:-1], x, side='right') — values equal to
    an interior edge fall in the upper bin; everything is clipped into
    [0, n_bins-1] by construction.
  * degenerate column (min == max): a single bin.

Two implementations:
  * host float64 (`bin_edges`, `discretize`) — canonical, digit-exact vs
    sklearn; used for reported MI numbers (copied from the JAX package).
  * f32 tensor form (`discretize_uniform`) on the tensor's device — the
    weight-grid search's binning, every combination in one call.
"""

from __future__ import annotations

import numpy as np
import torch


def bin_edges(x: np.ndarray, n_bins: int, strategy: str = "uniform") -> np.ndarray:
    """Bin edges exactly as sklearn KBinsDiscretizer.fit computes them."""
    x = np.asarray(x, dtype=np.float64).ravel()
    col_min, col_max = x.min(), x.max()
    if col_min == col_max:
        return np.array([-np.inf, np.inf])
    if strategy == "uniform":
        return np.linspace(col_min, col_max, n_bins + 1)
    if strategy == "quantile":
        quantiles = np.linspace(0, 100, n_bins + 1)
        edges = np.asarray(np.percentile(x, quantiles))
        # sklearn removes bins narrower than 1e-8 (keeps first edge).
        mask = np.ediff1d(edges, to_begin=np.inf) > 1e-8
        return edges[mask]
    raise ValueError(f"Unsupported strategy: {strategy}")


def discretize(x: np.ndarray, n_bins: int, strategy: str = "uniform") -> np.ndarray:
    """Ordinal-encoded bins, digit-exact vs sklearn's transform."""
    x = np.asarray(x, dtype=np.float64).ravel()
    edges = bin_edges(x, n_bins, strategy)
    return np.searchsorted(edges[1:-1], x, side="right").astype(np.int64)


def discretize_uniform(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Uniform-strategy binning on `x`'s device, over the last axis.

    x: (..., P) -> int32 bins (..., P) in [0, n_bins-1], the operations of
    JAX's discretize_uniform_jax: interior edges min + step * i (numpy's
    linspace form, not torch.linspace), a value on an edge in the upper bin
    (>=), a constant row all in bin 0. The step divides by a tensor: CUDA
    divides by a Python scalar through its reciprocal, which can move an edge
    by one ulp against the CPU."""
    mn = x.amin(-1, keepdim=True)
    mx = x.amax(-1, keepdim=True)
    step = (mx - mn) / torch.tensor(float(n_bins), dtype=x.dtype, device=x.device)
    i = torch.arange(1, n_bins, dtype=x.dtype, device=x.device)
    edges = mn[..., None] + step[..., None] * i  # (..., 1, n_bins-1)
    bins = (x[..., :, None] >= edges).sum(-1)
    return torch.where(mx == mn, 0, bins).to(torch.int32)
