"""The port's ops/metrics.py held against the JAX package's, function by
function, on the same numpy inputs.

Tolerance: f32 sums taken in another order (torch's CPU kernels against
XLA's) on scores of unit scale; query norms reach ~12 and row magnitudes 4,
so a magnitude difference carries ~2e-6. ATOL covers both."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.ops import metrics as JM
from image_retrieval_tpu_torch.index.vector_index import quantize_int8
from image_retrieval_tpu_torch.ops import metrics as TM

ATOL = 1e-5
# JAX's int8 scorer on XLA's CPU backend may keep f32 precision across a
# bf16 round trip (xla_allow_excess_precision), so it is held at the
# tolerance the JAX package's own tests use; the exact rounding points are
# pinned by the numpy reference below.
INT8_VS_JAX_ATOL = 2e-3
T = torch.from_numpy

WEIGHT_SETS = {
    "reference": (1, 1, 1, 0, 0.5),
    "cosine-only": (1.0, 0, 0, 0, 0),
    "all-live": (0.3, 0.2, 0.5, 0.7, 0.1),
    "no-angle": (0, 0.5, 0, 1.0, 0.25),
}


@functools.lru_cache(maxsize=None)
def _data(n=200, d=128, nq=4):
    """Unit rows with magnitudes in [0.5, 4] (one zero row), queries of
    norm ~11, one of them zero and one equal to a stored row."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    m = rng.uniform(0.5, 4.0, n).astype(np.float32)
    g[11], m[11] = 0.0, 0.0
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q[1] = 0.0
    q[2] = g[5] * m[5]
    return q, g, m


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_names_match_jax():
    assert TM.METRIC_NAMES == JM.METRIC_NAMES
    assert TM.ANALYSIS_METRICS == JM.ANALYSIS_METRICS
    assert TM.create_parameter_grid(4) == JM.create_parameter_grid(4)
    assert tuple(TM.create_parameter_grid()) == TM.WEIGHT_KEYS


@functools.lru_cache(maxsize=None)
def _pairwise(exact_l2, chunked):
    q, g, m = _data()
    rows = g * m[:, None]
    block = 64 if chunked else 4096  # 200 rows: four blocks, or one
    want = JM.pairwise_metrics(jnp.asarray(q), jnp.asarray(rows), exact_l2=exact_l2,
                               block_n=block)
    got = TM.pairwise_metrics(T(q), T(rows), exact_l2=exact_l2, block_n=block)
    return got, want


@pytest.mark.parametrize("metric", TM.METRIC_NAMES)
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("exact_l2", [False, True])
def test_pairwise_metrics_match_jax(metric, chunked, exact_l2):
    got, want = _pairwise(exact_l2, chunked)
    assert set(got) == set(TM.METRIC_NAMES)
    assert got[metric].shape == (4, 200) and got[metric].dtype == torch.float32
    # query 2 equals stored row 5. There the Gram-form L2 is the root of a
    # cancelled difference (both sides near 0 within sqrt(eps) * norm) and
    # arccos at cos = 1 turns one ulp of cos into sqrt(2 ulp) = 3.5e-4
    loose = (metric == "l2_distance" and not exact_l2) or metric == "angular_distance"
    _close(got[metric], want[metric], 2e-3 if loose else ATOL)
    planted = torch.zeros(4, 200, dtype=torch.bool)
    planted[2, 5] = True
    _close(got[metric].masked_fill(planted, 0.0),
           np.where(planted.numpy(), 0.0, np.asarray(want[metric])))
    if metric == "cosine_similarity":
        assert (got[metric][1] == 0).all() and (got[metric][:, 11] == 0).all()  # zero norms
    assert torch.isfinite(got[metric]).all()


def test_pairwise_metrics_subset_and_chunking_agree():
    q, g, m = _data()
    rows = g * m[:, None]
    one = TM.pairwise_metrics(T(q), T(rows), metrics=("l1_distance", "linf_distance"))
    many = TM.pairwise_metrics(T(q), T(rows), metrics=("l1_distance", "linf_distance"),
                               block_n=7)
    assert set(one) == {"l1_distance", "linf_distance"}
    for k in one:  # row-wise arithmetic: the split does not change a bit
        assert torch.equal(one[k], many[k])


@pytest.mark.parametrize("metric", TM.METRIC_NAMES)
def test_pair_metrics_match_jax(metric):
    q, g, m = _data()
    a, b = (g * m[:, None])[:50], (g * m[:, None])[50:100].copy()
    b[3] = a[3]
    b[7] = 0.0
    got = TM.pair_metrics(T(a), T(b))[metric]
    _close(got, JM.pair_metrics(jnp.asarray(a), jnp.asarray(b))[metric])
    assert got.shape == (50,)


def test_cosine_similarity_matches_jax():
    q, g, m = _data()
    got = TM.cosine_similarity(T(q), T(g * m[:, None]))
    _close(got, JM.cosine_similarity(jnp.asarray(q), jnp.asarray(g * m[:, None])))
    assert (got[1] == 0).all() and (got[:, 11] == 0).all()


@pytest.mark.parametrize("name", ["reference", "all-live"])
def test_optimized_similarity_matches_jax(name):
    q, g, m = _data()
    rows = g * m[:, None]
    params = dict(zip(TM.WEIGHT_KEYS, WEIGHT_SETS[name]))
    want = JM.optimized_similarity(jnp.asarray(q), jnp.asarray(rows), params)
    _close(TM.optimized_similarity(T(q), T(rows), params), want, 2e-3)  # Gram L2, see above
    _close(TM.optimized_distance(T(q), T(rows), params), -np.asarray(want), 2e-3)
    pm = TM.pairwise_metrics(T(q), T(rows), exact_l2=True)
    jm = JM.pairwise_metrics(jnp.asarray(q), jnp.asarray(rows), exact_l2=True)
    _close(TM.optimized_similarity_from_metrics(pm, params),
           JM.optimized_similarity_from_metrics(jm, params))
    _close(TM.optimized_similarity_from_metrics(pm, {}), jm["cosine_similarity"])


@pytest.mark.parametrize("name", list(WEIGHT_SETS))
@pytest.mark.parametrize("exact_l2", [True, False])
def test_fused_optimized_scores_xla_matches_jax(name, exact_l2):
    q, g, m = _data()
    w = WEIGHT_SETS[name]
    want = JM.fused_optimized_scores_xla(jnp.asarray(q), jnp.asarray(g), jnp.asarray(m), w,
                                         exact_l2)
    got = TM.fused_optimized_scores_xla(T(q), T(g), T(m), w, exact_l2)
    atol = 2e-3 if (not exact_l2 and w[2]) else ATOL  # the cancelled Gram L2 of query 2
    _close(got, want, atol)
    _close(got[[0, 1, 3]], np.asarray(want)[[0, 1, 3]])
    # row blocks of any size give the same bits for the row-wise terms
    small = TM.fused_optimized_scores_xla(T(q), T(g), T(m), w, exact_l2, block_n=33)
    np.testing.assert_allclose(small.numpy(), got.numpy(), rtol=0, atol=1e-6)
    # bf16 rows are upcast
    gb = T(g).to(torch.bfloat16)
    _close(TM.fused_optimized_scores_xla(T(q), gb, T(m), w, exact_l2),
           TM.fused_optimized_scores_xla(T(q), gb.float(), T(m), w, exact_l2).numpy(), 0)


def test_dead_terms_are_not_computed():
    """A weight that is a Python 0 drops its term before any arithmetic: an
    infinite magnitude then leaves a cosine-only score finite, while the
    same weight as a tensor multiplies 0 by inf. Both as in JAX."""
    q, g, m = _data()
    m = m.copy()
    m[4] = np.inf
    dead = TM.fused_optimized_scores_xla(T(q), T(g), T(m), (1.0, 0, 0, 0, 0))
    assert torch.isfinite(dead).all()
    _close(dead, JM.fused_optimized_scores_xla(jnp.asarray(q), jnp.asarray(g), jnp.asarray(m),
                                               (1.0, 0, 0, 0, 0)))
    zero = torch.zeros(())
    livew = TM.fused_optimized_scores_xla(T(q), T(g), T(m), (1.0, zero, zero, zero, zero))
    assert torch.isnan(livew[:, 4]).all() and torch.isfinite(livew[:, :4]).all()
    assert TM.live(0.5) and TM.live(zero) and not TM.live(0) and not TM.live(0.0)


def _bf16(x):
    """f32 -> nearest bf16 (ties to even), as f32, in numpy."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + (((u >> 16) & 1) + 0x7FFF)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _int8_numpy(q, g8, sc, m, w):
    """The int8 scorer's definition with every rounding point written out:
    bf16 query; exact products summed (here in float64); udots = dots * sc
    in f32; row_scale = bf16(sc * m); rec = bf16(int8 * row_scale);
    ad = |bf16(rec - q16)|; L1 = sum(ad) / D; Linf = max(ad)."""
    w_angle, w_l1, w_l2, w_inf, w_mag = w
    d = q.shape[1]
    qn = np.linalg.norm(q.astype(np.float32), axis=1, keepdims=True).astype(np.float32)
    q16 = _bf16(q)
    dots = (q16.astype(np.float64) @ g8.astype(np.float64).T).astype(np.float32)
    udots = dots * sc[None, :]
    score = np.zeros((q.shape[0], g8.shape[0]), np.float64)
    safe = np.where(qn > 0, qn, 1.0)
    score += w_angle * np.where(qn > 0, udots / safe, 0.0)
    sq = np.maximum(m[None, :] * m[None, :] - (2.0 * m[None, :]) * udots + qn * qn, 0.0)
    score -= w_l2 * (np.sqrt(sq.astype(np.float32)) / np.sqrt(np.float32(d)))
    rec = _bf16(g8.astype(np.float32) * _bf16(sc * m)[:, None])
    ad = np.abs(_bf16(rec[None, :, :] - q16[:, None, :]))
    score -= w_l1 * (ad.astype(np.float64).sum(-1) / d)
    score -= w_inf * ad.max(-1)
    score -= w_mag * np.abs(m[None, :] - qn)
    return score


@pytest.mark.parametrize("name", list(WEIGHT_SETS))
def test_int8_scorer_matches_jax_and_its_rounding_points(name):
    q, g, m = _data()
    g8, sc = quantize_int8(g)
    w = WEIGHT_SETS[name]
    got = TM.fused_optimized_scores_int8(T(q), T(g8), T(sc), T(m), w)
    want = JM.fused_optimized_scores_int8(jnp.asarray(q), jnp.asarray(g8), jnp.asarray(sc),
                                          jnp.asarray(m), w)
    _close(got, want, INT8_VS_JAX_ATOL)
    keep = [0, 1, 3]  # query 2 equals a stored row: its Gram L2 is a cancelled difference
    np.testing.assert_allclose(got.numpy()[keep], _int8_numpy(q, g8, sc, m, w)[keep],
                               rtol=0, atol=2e-6)
    # against the f32 scorer on the dequantized rows: the quantization floor
    deq = g8.astype(np.float32) * sc[:, None]
    f32 = TM.fused_optimized_scores_xla(T(q), T(deq), T(m), w, exact_l2=False)
    np.testing.assert_allclose(got.numpy()[keep], f32.numpy()[keep], rtol=0, atol=2e-2)
    small = TM.fused_optimized_scores_int8(T(q), T(g8), T(sc), T(m), w, block_n=33)
    np.testing.assert_allclose(small.numpy(), got.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(WEIGHT_SETS))
def test_shadow_scorer_is_bitwise_the_int8_scorer(name):
    q, g, m = _data()
    g8, sc = quantize_int8(g)
    w = WEIGHT_SETS[name]
    shadow = TM.make_l1_shadow(T(g8), T(sc), T(m))
    assert shadow.dtype == torch.bfloat16 and shadow.shape == g8.shape
    want = JM.make_l1_shadow(jnp.asarray(g8), jnp.asarray(sc), jnp.asarray(m))
    np.testing.assert_array_equal(shadow.float().numpy(), np.asarray(want, np.float32))
    a = TM.fused_optimized_scores_int8(T(q), T(g8), T(sc), T(m), w)
    b = TM.fused_optimized_scores_int8_shadow(T(q), T(g8), T(sc), T(m), shadow, w)
    assert torch.equal(a, b)
    _close(b, JM.fused_optimized_scores_int8_shadow(
        jnp.asarray(q), jnp.asarray(g8), jnp.asarray(sc), jnp.asarray(m), want, w),
        INT8_VS_JAX_ATOL)


def test_row_blocks_bound_the_broadcast():
    blocks = TM.row_blocks(1 << 20, 64, 512)
    assert blocks[0] == (0, TM.BROADCAST_ELEMS // (64 * 512)) and blocks[-1][1] == 1 << 20
    assert all(hi - lo <= 4096 for lo, hi in blocks)
    assert TM.row_blocks(10, 1, 8, block_n=4) == [(0, 4), (4, 8), (8, 10)]
    assert TM.row_blocks(0, 1, 8) == [(0, 0)]
