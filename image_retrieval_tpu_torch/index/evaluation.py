"""Shared ANN-tier evaluation helpers.

A verbatim copy of ``image_retrieval_tpu/index/evaluation.py`` (numpy only);
tests/test_torch_journal.py pins the code of the two copies together.
"""

from __future__ import annotations

import numpy as np


def mean_recall(got_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """Mean per-query top-k recall of `got_ids` against `exact_ids`.

    One definition shared by every ANN tier (IVF, screen) so the recall
    metric can never silently diverge between them. Row counts must match
    — a mismatch is a caller bug, not a truncation to hide (the old
    copies zip-truncated silently)."""
    got = np.atleast_2d(got_ids)
    exact = np.atleast_2d(exact_ids)
    if len(got) != len(exact):
        raise ValueError(
            f"mean_recall: {len(got)} result rows vs {len(exact)} exact rows")
    hits = sum(
        len(set(g.tolist()) & set(e.tolist())) / len(e)
        for g, e in zip(got, exact)
    )
    return hits / len(got)
