"""The int8-query form of the int4 screen
(image_retrieval_tpu_torch/ops/int4_screen.py: quantize_queries_i8,
int4_screen_scores_i8, int4_screen_topc(qform="i8")) held against the JAX
package's (int4_query_planes_i8, int4_screen_topc_pallas(qform="i8") in
Pallas interpret mode, the setup of tests/test_int4.py:550-591) and against
an integer simulation in numpy.

On the CPU the port's wrapper takes its plain version;
tests/test_torch_gpu.py holds the Hopper kernel to that plain version bit for
bit on the card. The integer dot is exact on both sides, so scores before
the query scale are equal bitwise; the selected values pass one more f32
multiply by the query scale, in another order of the three factors than the
simulation: 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.ops import int4 as jint4
from image_retrieval_tpu.ops import pallas_kernels as jpk
from image_retrieval_tpu_torch.ops import int4
from image_retrieval_tpu_torch.ops import int4_screen as k3
from image_retrieval_tpu_torch.parallel import collectives


def _unit_rows(rng, n, d):
    rows = rng.normal(size=(n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_n,d", [(1, 512), (5, 64), (7, 40), (130, 768)])
def test_query_quantizer_bitwise_equals_jax(q_n, d, dtype):
    """Values and scales of int4_query_planes_i8; the planes there are the
    int8 values regrouped by nibble position and zero-extended."""
    rng = np.random.default_rng(q_n * d)
    q = rng.normal(size=(q_n, d)).astype(np.float32) * rng.uniform(0.01, 30, size=(q_n, 1))
    q = q.astype(np.float32)
    if q_n > 1:
        q[1] = 0.0  # the 1e-12 floor
        q[2, :4] = np.array([0.5, -0.5, 1.5, 2.5]) * np.abs(q[2]).max() / 127  # halves
    jq = jnp.asarray(q).astype(getattr(jnp, dtype))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    q8, qs = k3.quantize_queries_i8(tq)
    assert q8.dtype == torch.int8 and q8.shape == (q_n, d)
    assert qs.dtype == torch.float32 and qs.shape == (q_n, 1)
    qf = jq.astype(jnp.float32)
    want_qs = jnp.maximum(jnp.max(jnp.abs(qf), axis=1, keepdims=True), 1e-12) / 127.0
    want_q8 = jnp.clip(jnp.round(qf / want_qs), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(qs.numpy().view(np.uint32),
                                  np.asarray(want_qs).view(np.uint32))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(want_q8))
    if d % 8 == 0:
        qp0, qp1, jqs = jpk.int4_query_planes_i8(jq)
        np.testing.assert_array_equal(np.asarray(jqs), qs.numpy())
        half = d // 8
        for j in range(8):
            plane = q8.numpy()[:, (2 * (j // 2) + (j % 2))::8]
            np.testing.assert_array_equal(np.asarray(qp0)[j][:, :half], plane)
            np.testing.assert_array_equal(np.asarray(qp1)[j][:, half:], plane)


@pytest.mark.parametrize("n,d,q_n", [(300, 64, 3), (257, 512, 5), (64, 30, 2)])
def test_plain_scores_equal_the_integer_simulation_bitwise(n, d, q_n):
    rng = np.random.default_rng(n + d)
    pk, sc = int4.quantize_pack_int4(_unit_rows(rng, n, d) * rng.uniform(0.5, 2, size=(n, 1)))
    valid = rng.random(n) > 0.2
    q8 = rng.integers(-127, 128, size=(q_n, d)).astype(np.int8)
    q8[0] = 127  # the extreme sums
    dots = q8.astype(np.int64) @ int4.unpack_nibbles(pk).astype(np.int64).T
    assert np.abs(dots).max() < 2 ** 24
    want = np.where(valid[None, :], dots.astype(np.float32) * sc[None, :], -np.inf)
    args = [torch.from_numpy(a) for a in (q8, pk, sc, valid)]
    before = k3.int4_screen_scores_i8.launches
    got = k3.int4_screen_scores_i8(*args)
    assert k3.int4_screen_scores_i8.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    seg = k3.int4_screen_scores_i8(*args, 17, 40)
    np.testing.assert_array_equal(seg.numpy(), want[:, 17:57].astype(np.float32))
    with pytest.raises(TypeError, match="int8 queries"):
        k3.int4_screen_scores_i8(args[0].to(torch.int16), *args[1:])


@pytest.mark.parametrize("seg_rows", [128, 512, 1 << 21])
def test_topc_i8_matches_jax_pallas(seg_rows):
    """The setup of tests/test_int4.py::test_pallas_screen_qform_i8_exact_integer_math:
    the JAX kernel interpreted over paired words, the port over nibble rows:
    the same candidate ids, values to 1e-6."""
    rng = np.random.default_rng(9)
    n, d, q_n, c = 512, 512, 3, 16
    pk, sc = jint4.quantize_pack_int4(_unit_rows(rng, n, d))
    q = _unit_rows(rng, q_n, d)
    valid = np.ones(n, bool)
    valid[rng.choice(n, 40, replace=False)] = False
    tv, ti = jpk.int4_screen_topc_pallas(
        jnp.asarray(q), jnp.asarray(jpk.pack_words_paired(pk)), jnp.asarray(sc),
        jnp.asarray(valid), c, block_n=128, seg_rows=512, qform="i8")
    tv, ti = np.asarray(tv), np.asarray(ti)
    gv, gi = k3.int4_screen_topc(*(torch.from_numpy(a) for a in (q, pk, sc, valid)), c,
                                 seg_rows=seg_rows, qform="i8")
    assert gv.shape == gi.shape == (q_n, c) and gi.dtype == torch.int64
    for r in range(q_n):
        # the JAX merge orders by value; equal values may come in another order
        np.testing.assert_array_equal(np.sort(gi[r].numpy()), np.sort(ti[r]))
        np.testing.assert_allclose(np.sort(gv[r].numpy()), np.sort(tv[r]), rtol=1e-6, atol=1e-7)
    assert valid[gi.numpy()].all()


def test_topc_i8_ranks_like_bf16_up_to_the_query_grid():
    rng = np.random.default_rng(10)
    n, d, q_n, c = 2000, 512, 6, 32
    pk, sc = int4.quantize_pack_int4(_unit_rows(rng, n, d))
    q = torch.from_numpy(_unit_rows(rng, q_n, d))
    args = [torch.from_numpy(a) for a in (pk, sc, np.ones(n, bool))]
    v8, i8 = k3.int4_screen_topc(q, *args, c, seg_rows=512, qform="i8")
    vb, ib = k3.int4_screen_topc(q.to(torch.bfloat16), *args, c, seg_rows=512)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / c for a, b in zip(i8, ib)])
    assert overlap >= 0.9, overlap
    # the scale is back on the values: approximate cosines, like the bf16 form's
    assert float((v8[:, 0] - vb[:, 0]).abs().max()) <= 5e-3
    # fewer valid rows than c: -inf padding survives the query scale
    few = torch.zeros(n, dtype=torch.bool)
    few[:5] = True
    v, _ = k3.int4_screen_topc(q, args[0], args[1], few, c, qform="i8")
    assert torch.isfinite(v[:, :5]).all() and torch.isinf(v[:, 5:]).all()


def test_qform_argument_and_the_index_constant(monkeypatch):
    """No index tier selects "i8": the sweeps pass the module constant, which
    stays "bf16" as in the JAX package (parallel/collectives.py:27)."""
    from image_retrieval_tpu.parallel import collectives as jcollectives

    assert collectives.INT4_SCREEN_QFORM == jcollectives.INT4_SCREEN_QFORM == "bf16"
    rng = np.random.default_rng(11)
    pk, sc = int4.quantize_pack_int4(_unit_rows(rng, 64, 32))
    q, pk, sc, valid = (torch.from_numpy(a) for a in
                        (_unit_rows(rng, 2, 32), pk, sc, np.ones(64, bool)))
    with pytest.raises(ValueError, match="qform"):
        k3.int4_screen_topc(q, pk, sc, valid, 8, qform="int8")
    seen = []
    real = k3.int4_screen_topc

    def spy(*a, **kw):
        seen.append(kw.get("qform"))
        return real(*a, **kw)

    monkeypatch.setattr(collectives, "int4_screen_topc", spy)
    collectives.sharded_int4_screen_topk(q, pk, valid, sc, 8)
    assert seen == ["bf16"]
