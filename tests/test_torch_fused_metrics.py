"""The fused metric kernels' plain versions (what the wrappers of
ops/fused_metrics.py run on CPU tensors) held against the JAX package's
Pallas kernels in interpret mode and against their XLA mirrors, on the same
numpy inputs; and the kernel-vs-plain limits shown to reject wrong kernels,
a perturbed plain version standing in for the kernel.

Tolerance against JAX: f32 sums in another order on scores of unit scale
(1e-5); the Gram-form L2 of a query that equals a stored row is the root of
a cancelled difference and is compared through ``gram_l2_slack``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.ops import metrics as JM
from image_retrieval_tpu.ops import pallas_kernels as PK
from image_retrieval_tpu.ops.topk import exact_topk as jax_exact_topk
from image_retrieval_tpu_torch.index.vector_index import quantize_int8
from image_retrieval_tpu_torch.ops import fused_metrics as FM
from image_retrieval_tpu_torch.ops import metrics as TM

ATOL = 1e-5
INT8_VS_JAX_ATOL = 2e-3  # XLA's CPU backend may skip a bf16 rounding (see test_torch_metrics)
T = torch.from_numpy
J = jnp.asarray

WEIGHT_SETS = {
    "reference": (1.0, 1.0, 1.0, 0.0, 0.5),
    "cosine-only": (1.0, 0.0, 0.0, 0.0, 0.0),
    "all-live": (0.3, 0.2, 0.5, 0.7, 0.1),
}
SHAPES = {"ragged-q3": (150, 3), "even-q1": (256, 1)}


@functools.lru_cache(maxsize=None)
def _data(n, nq, d=128):
    """Unit rows with magnitudes in [0.5, 4], rows 3 and 7 identical (a tie),
    unnormalized queries, the last equal to stored row 5."""
    rng = np.random.default_rng(n + nq)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    m = rng.uniform(0.5, 4.0, n).astype(np.float32)
    g[7], m[7] = g[3], m[3]
    q = (rng.standard_normal((nq, d)) * 0.3).astype(np.float32)
    q[-1] = g[5] * m[5]
    return q, g, m


def _limit(want, q, g, m, w_l2):
    """score_limit with the Gram slack of these inputs."""
    qn = torch.linalg.vector_norm(T(q), dim=1, keepdim=True)
    sq = TM.gram_sq(T(m), T(q) @ T(g).t(), qn)
    return FM.score_limit(want, w_l2, FM.gram_l2_slack(sq, T(m), qn, q.shape[1]))


# ---- plain versions against the Pallas kernels and their XLA mirrors --------

@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_all_metrics_matches_pallas_and_xla(shape):
    q, g, m = _data(*SHAPES[shape])
    got = FM.fused_all_metrics(T(q), T(g), T(m))
    assert got.shape == (5, q.shape[0], g.shape[0]) and got.dtype == torch.float32
    want = np.asarray(PK.fused_all_metrics(J(q), J(g), J(m), block_n=64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    mirror = JM.pairwise_metrics(J(q), J(g * m[:, None]), metrics=PK.PLANES, exact_l2=True)
    for plane, name in zip(got, FM.PLANES):
        np.testing.assert_allclose(plane.numpy(), np.asarray(mirror[name]), rtol=0, atol=ATOL)
    assert FM.PLANES == PK.PLANES


def test_fused_all_metrics_zero_norm_query_and_zero_row():
    q, g, m = (a.copy() for a in _data(150, 3))
    q[0] = 0.0
    g[9], m[9] = 0.0, 0.0
    got = FM.fused_all_metrics(T(q), T(g), T(m))
    assert torch.isfinite(got).all()
    assert (got[0, 0] == 0).all() and (got[0, :, 9] == 0).all()  # cosine 0, not NaN
    np.testing.assert_allclose(got.numpy(), np.asarray(PK.fused_all_metrics(J(q), J(g), J(m))),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(WEIGHT_SETS))
def test_fused_optimized_scores_matches_pallas_and_xla(shape, name):
    q, g, m = _data(*SHAPES[shape])
    w = np.asarray(WEIGHT_SETS[name], np.float32)
    got = FM.fused_optimized_scores(T(q), T(g), T(m), T(w))
    want = T(np.asarray(PK.fused_optimized_scores(J(q), J(g), J(m), J(w), block_n=64)))
    lim = _limit(want, q, g, m, float(w[2])) + ATOL
    assert FM.scores_agree(got, want, lim)["ok"]
    mirror = JM.optimized_similarity(J(q), J(g * m[:, None]),
                                     dict(zip(TM.WEIGHT_KEYS, map(float, w))))
    assert FM.scores_agree(got, T(np.asarray(mirror)), lim)["ok"]
    # a sequence of numbers is the same weights
    assert torch.equal(got, FM.fused_optimized_scores(T(q), T(g), T(m), list(map(float, w))))


def test_fused_optimized_scores_takes_every_term():
    """Run-time weights: nothing is skipped, so a zero weight times an
    infinite term is NaN, as in the Pallas kernel."""
    q, g, m = (a.copy() for a in _data(150, 3))
    m[4] = np.inf
    got = FM.fused_optimized_scores(T(q), T(g), T(m), torch.tensor([1.0, 0, 0, 0, 0]))
    assert torch.isnan(got[:, 4]).all() and torch.isfinite(got[:, :4]).all()


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(WEIGHT_SETS))
@pytest.mark.parametrize("n,nq,k", [(150, 3, 10), (256, 1, 64), (5, 2, 10)])
def test_fused_optimized_topk_matches_pallas_and_xla(n, nq, k, name, rows):
    q, g, m = _data(max(n, 150), nq)
    g, m = g[:n], m[:n]  # n = 5: fewer rows than k
    w = WEIGHT_SETS[name]
    tg, jg = T(g), J(g)
    if rows == "bfloat16":
        tg, jg = tg.to(torch.bfloat16), jg.astype(jnp.bfloat16)
    got_v, got_i = FM.fused_optimized_topk(T(q), tg, T(m), w, k=k)
    kk = min(k, n)
    assert got_v.shape == got_i.shape == (nq, kk) and got_i.dtype == torch.int32
    # the Pallas kernel, blocks of 64 rows (k = 64 fills a whole block)
    pv, pi = PK.fused_optimized_topk(J(q), jg, J(m), w, k=k, block_n=64)
    # the XLA mirror: the scorer, then the exact top-k
    plain = TM.fused_optimized_scores_xla(T(q), tg, T(m), w, exact_l2=False)
    lim = _limit(plain, q, g, m, w[2]) + ATOL
    for want_v, want_i in ((pv, pi), jax_exact_topk(
            JM.fused_optimized_scores_xla(J(q), jg, J(m), w, exact_l2=False), kk)):
        r = FM.topk_agree(got_v, got_i, T(np.asarray(want_v)),
                          T(np.asarray(want_i)).to(torch.int64), plain, lim)
        assert r["ok"], r
    if n > 7:  # rows 3 and 7 are identical: wherever both rank, 3 comes first
        for row in got_i.tolist():
            if 3 in row and 7 in row:
                assert row.index(7) == row.index(3) + 1


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(WEIGHT_SETS))
@pytest.mark.parametrize("entry", ["fused_optimized_scores_int8_pallas",
                                   "fused_optimized_scores_int8_pallas_v2"])
def test_int8_entries_match_pallas_and_xla(entry, name, shape):
    q, g, m = _data(*SHAPES[shape])
    g8, sc = quantize_int8(g)
    w = WEIGHT_SETS[name]
    got = getattr(FM, entry)(T(q), T(g8), T(sc), T(m), w)
    want = getattr(PK, entry)(J(q), J(g8), J(sc), J(m), w, block_n=64)
    mirror = JM.fused_optimized_scores_int8(J(q), J(g8), J(sc), J(m), w)
    planted = np.zeros(got.shape, bool)
    planted[-1, 5] = True  # the last query equals row 5: a cancelled Gram L2
    for other in (want, mirror):
        np.testing.assert_allclose(np.where(planted, 0.0, got.numpy()),
                                   np.where(planted, 0.0, np.asarray(other)), rtol=0,
                                   atol=INT8_VS_JAX_ATOL)
    # the port's own int8 scorer is the plain version, bit for bit
    assert torch.equal(got, TM.fused_optimized_scores_int8(T(q), T(g8), T(sc), T(m), w))


def test_two_int8_names_one_kernel():
    assert FM.fused_optimized_scores_int8_pallas_v2 is FM.fused_optimized_scores_int8_pallas


# ---- wrappers ---------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    q, g, m = _data(150, 3)
    g8, sc = quantize_int8(g)
    entries = (FM.fused_all_metrics, FM.fused_optimized_scores, FM.fused_optimized_topk,
               FM.fused_optimized_scores_int8_pallas)
    before = [e.launches for e in entries]
    w = WEIGHT_SETS["reference"]
    assert torch.equal(FM.fused_all_metrics(T(q), T(g), T(m)),
                       FM.fused_all_metrics_reference(T(q), T(g), T(m)))
    assert torch.equal(FM.fused_optimized_scores(T(q), T(g), T(m), w),
                       FM.fused_optimized_scores_reference(T(q), T(g), T(m), w))
    for a, b in zip(FM.fused_optimized_topk(T(q), T(g), T(m), w, 10),
                    FM.fused_optimized_topk_reference(T(q), T(g), T(m), w, 10)):
        assert torch.equal(a, b)
    assert torch.equal(
        FM.fused_optimized_scores_int8_pallas(T(q), T(g8), T(sc), T(m), w),
        FM.fused_optimized_scores_int8_reference(T(q), T(g8), T(sc), T(m), w))
    assert [e.launches for e in entries] == before


@pytest.mark.parametrize("call,error", [
    (lambda q, g, m, g8, sc: FM.fused_all_metrics(q, g[:, :64], m), ValueError),
    (lambda q, g, m, g8, sc: FM.fused_all_metrics(q, g, m[:-1]), ValueError),
    (lambda q, g, m, g8, sc: FM.fused_all_metrics(q, g.double(), m), TypeError),
    (lambda q, g, m, g8, sc: FM.fused_optimized_scores(q, g.to(torch.bfloat16), m,
                                                       torch.ones(5)), TypeError),
    (lambda q, g, m, g8, sc: FM.fused_optimized_scores(q, g, m, torch.ones(4)), ValueError),
    (lambda q, g, m, g8, sc: FM.fused_optimized_topk(q, g, m, (1, 0, 0, 0)), ValueError),
    (lambda q, g, m, g8, sc: FM.fused_optimized_topk(q, g, m, (1, 0, 0, 0, 0), k=0),
     ValueError),
    (lambda q, g, m, g8, sc: FM.fused_optimized_topk(q, g8, m, (1, 0, 0, 0, 0)), TypeError),
    (lambda q, g, m, g8, sc: FM.fused_optimized_scores_int8_pallas(q, g, sc, m,
                                                                    (1, 0, 0, 0, 0)), TypeError),
    (lambda q, g, m, g8, sc: FM.fused_optimized_scores_int8_pallas(q, g8, sc[:-1], m,
                                                                    (1, 0, 0, 0, 0)), ValueError),
])
def test_wrappers_reject_bad_input(call, error):
    q, g, m = _data(150, 3)
    g8, sc = quantize_int8(g)
    with pytest.raises(error):
        call(T(q), T(g), T(m), T(g8), T(sc))


# ---- the limits reject wrong kernels ----------------------------------------

def _scores_with(q, g, m, w, *, drop_mag=False, keep_sqrt_d=True):
    """The f32 Gram scorer, optionally wrong in the way named."""
    q, g, m = T(q), T(g), T(m)
    d = q.shape[1]
    qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    dots = q @ g.t()
    gu = g if drop_mag else g * m[:, None]
    ad = (gu[None] - q[:, None, :]).abs()
    l2 = torch.sqrt(TM.gram_sq(m, dots, qn)) / (d ** 0.5 if keep_sqrt_d else 1.0)
    return (w[0] * TM._safe_div(dots, qn) - w[1] * ad.sum(-1) / d - w[3] * ad.amax(-1)
            - w[2] * l2 - w[4] * (m[None] - qn).abs())


@pytest.mark.parametrize("wrong", ["dropped-mag", "l2-without-sqrt-d"])
@pytest.mark.parametrize("name", ["reference", "all-live"])
def test_score_limit_rejects_a_wrong_f32_kernel(name, wrong):
    q, g, m = _data(150, 3)
    w = WEIGHT_SETS[name]
    want = FM.fused_optimized_scores_reference(T(q), T(g), T(m), w)
    lim = _limit(want, q, g, m, w[2])
    right = _scores_with(q, g, m, w)  # other operation order, same function
    assert FM.scores_agree(right, want, lim)["ok"]
    bad = _scores_with(q, g, m, w, drop_mag=wrong == "dropped-mag",
                       keep_sqrt_d=wrong != "l2-without-sqrt-d")
    r = FM.scores_agree(bad, want, lim)
    assert not r["ok"] and r["worst_ratio"] > 100


@pytest.mark.parametrize("wrong", ["dropped-mag", "l2-without-sqrt-d"])
def test_score_limit_rejects_wrong_planes(wrong):
    q, g, m = _data(150, 3)
    want = FM.fused_all_metrics_reference(T(q), T(g), T(m))
    if wrong == "dropped-mag":
        bad = FM.fused_all_metrics_reference(T(q), T(g), torch.ones(len(m)))
        bad[4] = want[4]
    else:
        bad = want.clone()
        bad[2] *= q.shape[1] ** 0.5
    assert FM.scores_agree(want + 1e-7, want, FM.score_limit(want))["ok"]
    assert not FM.scores_agree(bad, want, FM.score_limit(want))["ok"]


def test_gram_slack_is_wide_only_at_the_cancellation():
    """The limit lets the Gram-form L2 of the planted row (query == row) move
    by what a last-bit change of the product does, and nothing elsewhere."""
    q, g, m = _data(150, 3)
    w = (0.0, 0.0, 1.0, 0.0, 0.0)
    want = FM.fused_optimized_scores_reference(T(q), T(g), T(m), w)
    lim = _limit(want, q, g, m, 1.0)
    assert lim[-1, 5] > 20 * lim[0, 5] and lim[-1, 5] < 2e-3
    assert float(lim[:-1].max()) < 1e-5
    # the same scorer with the product computed in float64 and rounded
    qn = torch.linalg.vector_norm(T(q), dim=1, keepdim=True)
    dots = (T(q).double() @ T(g).double().t()).float()
    other = -(torch.sqrt(TM.gram_sq(T(m), dots, qn)) / q.shape[1] ** 0.5)
    assert FM.scores_agree(other, want, lim)["ok"]


def test_score_limit_rejects_an_int8_difference_left_in_f32():
    """K5's contract rounds rec - q16 to bf16. Leaving it in f32 moves L1 by
    ~1e-5 absolute here (unbiased roundings of 128 terms average out) and
    Linf by ~1e-3: both far outside what the order of f32 sums can do."""
    q, g, m = _data(150, 3)
    g8, sc = quantize_int8(g)
    rec = TM.make_l1_shadow(T(g8), T(sc), T(m)).float()
    ad = (rec[None] - T(q).to(torch.bfloat16).float()[:, None, :]).abs()  # f32 difference
    for w, floor in (((1.0, 1.0, 0.0, 0.0, 0.0), 3.0), ((0.0, 0.0, 0.0, 1.0, 0.0), 100.0)):
        want = FM.fused_optimized_scores_int8_reference(T(q), T(g8), T(sc), T(m), w)
        bad = FM.fused_optimized_scores_int8_reference(T(q), T(g8), T(sc), T(m),
                                                       (w[0], 0.0, 0.0, 0.0, 0.0))
        bad = bad - w[1] * ad.sum(-1) / q.shape[1] - w[3] * ad.amax(-1)
        r = FM.scores_agree(bad, want, FM.score_limit(want))
        assert not r["ok"] and r["worst_ratio"] > floor, r
    # summing the right (bf16) differences in float64 instead stays inside
    ad16 = (TM.make_l1_shadow(T(g8), T(sc), T(m))[None]
            - T(q).to(torch.bfloat16)[:, None, :]).abs()
    w = (1.0, 1.0, 0.0, 0.0, 0.0)
    want = FM.fused_optimized_scores_int8_reference(T(q), T(g8), T(sc), T(m), w)
    ok = FM.fused_optimized_scores_int8_reference(T(q), T(g8), T(sc), T(m),
                                                  (1.0, 0.0, 0.0, 0.0, 0.0))
    ok = ok - (ad16.double().sum(-1) / q.shape[1]).float()
    assert FM.scores_agree(ok, want, FM.score_limit(want))["ok"]


def test_topk_agree_rejects_ties_broken_by_the_higher_row():
    q, g, m = _data(150, 3)
    w = WEIGHT_SETS["reference"]
    plain = FM.fused_optimized_scores_reference(T(q), T(g), T(m), w)
    plain[:, 7] = plain[:, 3] = plain.max() + 1.0  # rows 3 and 7 tie at the top
    plain[:, 20] = plain[:, 3] - 1e-7 * plain[:, 3].abs()  # a near tie just below
    lim = FM.score_limit(plain)
    want_v, want_i = torch.sort(plain, dim=1, descending=True, stable=True)
    want_v, want_i = want_v[:, :10], want_i[:, :10]
    assert want_i[:, :3].tolist() == [[3, 7, 20]] * 3
    assert FM.topk_agree(want_v, want_i.to(torch.int32), want_v, want_i, plain, lim)["ok"]
    # a near tie may swap
    near_i = want_i.clone()
    near_i[:, [1, 2]] = want_i[:, [2, 1]]
    r = FM.topk_agree(torch.gather(plain, 1, near_i), near_i, want_v, want_i, plain, lim)
    assert r["ok"] and r["swaps"] == 6
    # an exact tie may not: the higher row first
    bad_i = want_i.clone()
    bad_i[:, [0, 1]] = want_i[:, [1, 0]]
    r = FM.topk_agree(torch.gather(plain, 1, bad_i), bad_i, want_v, want_i, plain, lim)
    assert not r["ok"] and "ascending" in r["why"]
    # a row from far below the boundary, a wrong value, an index off the end
    far_i = want_i.clone()
    far_i[:, 9] = torch.sort(plain, dim=1, descending=True)[1][:, 100]
    assert not FM.topk_agree(torch.gather(plain, 1, far_i), far_i, want_v, want_i, plain,
                             lim)["ok"]
    assert not FM.topk_agree(want_v + 1e-3, want_i, want_v, want_i, plain, lim)["ok"]
    off = want_i.clone()
    off[0, 0] = plain.shape[1]
    assert not FM.topk_agree(want_v, off, want_v, want_i, plain, lim)["ok"]


def test_scores_agree_needs_the_same_infinities():
    want = torch.tensor([[1.0, float("-inf"), 2.0]])
    assert FM.scores_agree(want.clone(), want, 1e-6)["ok"]
    assert not FM.scores_agree(torch.tensor([[1.0, 0.0, 2.0]]), want, 1e-6)["ok"]
    assert not FM.scores_agree(torch.tensor([[1.0, float("-inf"), 2.1]]), want, 1e-6)["ok"]
