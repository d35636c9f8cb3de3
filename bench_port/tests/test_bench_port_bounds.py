"""The frozen bound arithmetic, pinned to values worked out by hand (and to
the bounds chip_smoke.py printed for the same shapes, PERF.md section 6)."""

import pytest

from bench_port import bounds

L14 = dict(image_size=224, patch_size=14, vision_width=1024, vision_layers=24,
           vision_heads=16, text_width=768, text_layers=12, text_heads=12,
           context_length=77, embed_dim=768, int8_matmuls=True)
B32 = dict(image_size=224, patch_size=32, vision_width=768, vision_layers=12,
           vision_heads=12, text_width=512, text_layers=12, text_heads=8,
           context_length=77, embed_dim=512, int8_matmuls=True)
W_REF = dict(w_angle=1.0, w_l1=1.0, w_l2=1.0, w_inf=0.0, w_mag=0.5)


def test_l14_image_is_162_gflop():
    # 24 layers x 257 tokens x (8 W^2 + 4 W 4W) int8 ops, 24 x 4 x 257^2 x W
    # attention flops, the 256-patch embedding and the projection
    w = bounds.tower_work(L14, "vision", 1)
    assert w["int8"] == 24 * 257 * (8 * 1024 ** 2 + 4 * 1024 * 4096)
    assert w["bf16"] == 24 * 4 * 257 ** 2 * 1024 + 2 * 256 * 588 * 1024
    assert sum(w.values()) / 1e9 == pytest.approx(162.03, abs=0.01)
    assert bounds.seconds_at_peak(w) * 1e6 == pytest.approx(85.32, abs=0.01)


def test_b32_text_query_counts_the_causal_pairs():
    w = bounds.tower_work(B32, "text", 64)
    assert w["int8"] == 12 * 64 * 77 * (8 * 512 ** 2 + 4 * 512 * 2048)
    assert w["bf16"] == 12 * 4 * 64 * (77 * 78 // 2) * 512


def test_f32_sweep_over_4m_rows_is_bytes_bound_at_2_57_ms():
    b = bounds.sweep_bound("float32", None, 64, 4_194_304, 512)
    assert b["bound_by"] == "bytes"
    # rows 2,048 bytes + the magnitude's 4 each, the queries once
    assert b["bound_ms"] == pytest.approx((4_194_304 * 2052 + 64 * 512 * 4) / 3.35e12 * 1e3)
    assert b["bound_ms"] == pytest.approx(2.569, abs=1e-3)
    # the split-TF32 products (6 flops a multiply-add at 495 TFLOP/s) take less
    assert 6 * 64 * 4_194_304 * 512 / 495e12 * 1e3 == pytest.approx(1.665, abs=1e-3)


def test_int8_sweeps():
    cos = bounds.sweep_bound("int8", None, 48, 2_097_152, 768)
    assert cos["bound_by"] == "bytes"
    assert cos["bound_ms"] == pytest.approx((2_097_152 * 772 + 48 * 768 * 4) / 3.35e12 * 1e3)
    k5 = bounds.sweep_bound("int8", bounds.wtuple(W_REF), 16, 2_097_152, 768)
    el = 16 * 2_097_152 * 768
    ops_ms = (4 * el / 989e12 + 0.5 * el / 33.5e12) * 1e3
    # rows, scales, magnitudes and the (Q, N) f32 scores, the queries once
    bytes_ms = (2_097_152 * (776 + 16 * 4) + 16 * 768 * 4) / 3.35e12 * 1e3
    assert ops_ms == pytest.approx(0.489, abs=1e-3) and bytes_ms == pytest.approx(0.526, abs=1e-3)
    assert k5 == {"bound_ms": pytest.approx(bytes_ms), "bound_by": "bytes"}
    assert k5 == bounds.k5_bounds(W_REF, 16, 2_097_152, 768)[0]


def test_copies_give_chip_smokes_bounds():
    # K2a and K2b at L/14 vision B = 128: 0.1745 and 0.2789 ms (operations)
    t, w = 257, 1024
    k2a = bounds.block_bound("attn", 128, t, w, 4 * w, False, 128 * t * w * 2, 0)
    k2b = bounds.block_bound("mlp", 128, t, w, 4 * w, False, 128 * t * w * 2, 0)
    assert k2a["bound_ms"] == pytest.approx(0.1745, abs=1e-4)
    assert k2b["bound_ms"] == pytest.approx(0.2789, abs=1e-4)
    # K5 at Q = 64 over 1,049,728 x 768 rows with the reference weights: 0.9788
    assert bounds.k5_bounds(W_REF, 64, 1_049_728, 768)[0]["bound_ms"] == pytest.approx(
        0.9788, abs=1e-4)
    # K4 cosine-only at Q = 64 over 1,001,344 x 512 f32 rows: 0.6134 (bytes)
    k4 = bounds.f32_bounds(dict(w_angle=1.0), 64, 1_001_344, 512, 4, 64 * 10 * 8)[0]
    assert k4["bound_by"] == "bytes" and k4["bound_ms"] == pytest.approx(0.6134, abs=1e-4)


def test_bound_takes_the_larger():
    assert bounds.bound(1979e9, 0.0, 0.0) == {"bound_ms": pytest.approx(1.0),
                                              "bound_by": "operations"}
    assert bounds.bound(0.0, 0.0, 3.35e10)["bound_by"] == "bytes"
