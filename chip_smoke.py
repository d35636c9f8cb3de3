#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's text->image serving path once on one GPU.

    python3 chip_smoke.py    # needs one CUDA card and nvcc

Phases (any failure exits non-zero):
  1. card and build: the card's name and power limit (nvidia-smi), then the
     port's kernels compiled from image_retrieval_tpu_torch/csrc with nvcc
     for sm_90a.
  2. kernel vs plain: layer_block_int8 on the card against its plain
     PyTorch version on the same inputs, at the ViT-B/32 tower shapes
     (vision B=8 T=50 W=768 12 heads; text B=8 T=77 W=512 8 heads, causal),
     in bf16 and f32, with timings (CUDA events, median of 24 samples taken
     in turns plain/kernel/kernel/plain).
  3. the slice: CLIPEncoder(vit_b32_serving, seed 0) at full width on the
     card encodes 256 seeded uint8 images; they and 1,000,000 seeded unit
     rows go into the f32 ShardedVectorIndex; SearchServer answers 64
     concurrent text queries, each checked against a float64 numpy oracle.
     The kernel's launch counter must show one launch per layer per encoded
     batch, and the towers must agree with the same model on CPU tensors.

Prints the card line, a JSON line of per-kernel results, and, last, the
{"ok": true, "device": ...} line. Imports no JAX: the port reads only the
JAX package's framework-free config module and vendored BPE vocab.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# Kernel vs plain per layer: the limits of ops.flash_attention's
# kernel_agreement (max abs error per dtype, share of elements off by more
# than 1e-3, per-token cosine of the layer's update), set from int8
# rounding flips and shown there to reject a layer that drops a bias add.
# Whole towers compound 12 layers of flips, so they are held by cosine.
TOWER_MIN_COS = 0.999  # embeddings of the CUDA towers vs the CPU towers
ORACLE_SCORE_ATOL = 1e-5  # f32 sweep vs float64 oracle, unit rows, D = 512
N_IMAGES, N_ROWS, N_CLIENTS, TOP_K = 256, 1_000_000, 64, 10


def fail(msg: str):
    raise RuntimeError(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def row_cos(a, b):
    a = a.reshape(-1, a.shape[-1]).double()
    b = b.reshape(-1, b.shape[-1]).double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-30))


def layer_inputs(torch, b, t, w, heads, seed):
    """Seeded layer weights at the CLIP-like scales of models/weights.py
    init_params, and an input of unit scale."""
    from image_retrieval_tpu_torch.ops.flash_attention import quantize_layer

    rng = np.random.default_rng(seed)
    nrm = lambda std, *s: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32))
    in_std = w ** -0.5 * 24 ** -0.5
    params = [1.0 + nrm(0.02, w), nrm(0.02, w),
              nrm(in_std, w, w), nrm(0.02, w), nrm(in_std, w, w), nrm(0.02, w),
              nrm(in_std, w, w), nrm(0.02, w), nrm(w ** -0.5, w, w), nrm(0.02, w),
              1.0 + nrm(0.02, w), nrm(0.02, w),
              nrm((2 * w) ** -0.5, w, 4 * w), nrm(0.02, 4 * w),
              nrm(in_std, 4 * w, w), nrm(0.02, w)]
    x = nrm(1.0, b, t, w)
    return x, quantize_layer(*[p.cuda() for p in params])


def time_pair(torch, fns, samples=24, reps=5):
    """Median ms per call of each fn; samples taken in turns
    plain/kernel/kernel/plain, each the mean of `reps` back-to-back calls
    between CUDA events."""
    def one(fn):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    for fn in fns.values():  # warm
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    got = {k: [] for k in fns}
    for _ in range(samples // 2):
        for k in ("plain", "kernel", "kernel", "plain"):
            got[k].append(one(fns[k]))
    return {k: float(np.median(v)) for k, v in got.items()}


def phase_kernels(torch, card):
    """Kernel vs plain at both tower shapes; returns the largest error and
    the bf16 times per shape."""
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    shapes = {"vision": (8, 50, 768, 12, False), "text": (8, 77, 512, 8, True)}
    max_err, times = 0.0, {}
    for name, (b, t, w, heads, causal) in shapes.items():
        x32, wts = layer_inputs(torch, b, t, w, heads, seed=len(name))
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(device="cuda", dtype=dt)
            got = fa.layer_block_int8(x, wts, heads, causal)
            want = fa.layer_block_int8_reference(x, wts, heads, causal)
            torch.cuda.synchronize()
            r = fa.kernel_agreement(got, want, x)
            max_err = max(max_err, r["max_abs_err"])
            print(f"kernel-vs-plain {name} {str(dt)[6:]}: max_abs_err "
                  f"{r['max_abs_err']:.6g} (limit {r['max_abs_limit']:.6g}), "
                  f"{r['flip_share']:.4%} of elements off by > {fa.AGREE_FLIP_ATOL} "
                  f"(limit {fa.AGREE_FLIP_SHARE:.0%}), min per-token cos of the "
                  f"update {r['min_update_cos']:.8f} (limit "
                  f"{fa.AGREE_MIN_UPDATE_COS})", flush=True)
            if not r["ok"]:
                fail(f"layer_block_int8 {name} {dt} disagrees with its plain version")
        xb = x32.to(device="cuda", dtype=torch.bfloat16)
        times[name] = time_pair(torch, {
            "kernel": lambda: fa.layer_block_int8(xb, wts, heads, causal),
            "plain": lambda: fa.layer_block_int8_reference(xb, wts, heads, causal),
        })
        print(f"layer time {name} bf16 B={b} T={t} W={w}: kernel "
              f"{times[name]['kernel']:.4f} ms, plain {times[name]['plain']:.4f} ms "
              f"per layer [{card}]", flush=True)
    return max_err, times


def oracle_topk(gallery: np.ndarray, queries: np.ndarray, k: int):
    """float64 cosine of raw queries against unit rows; top-(k+1) with
    lowest-index ties. Returns (scores (Q, k+1) f64, ids (Q, k+1))."""
    q = queries.astype(np.float64)
    qn = np.linalg.norm(q, axis=1, keepdims=True)
    s = np.empty((q.shape[0], gallery.shape[0]), np.float64)
    step = 1 << 17
    for i in range(0, gallery.shape[0], step):
        s[:, i: i + step] = q @ gallery[i: i + step].astype(np.float64).T
    s = np.where(qn > 0, s / np.where(qn > 0, qn, 1.0), 0.0)
    vals, ids = [], []
    for row in s:
        thr = np.partition(row, -(k + 1))[-(k + 1)]
        cand = np.flatnonzero(row >= thr)
        order = cand[np.lexsort((cand, -row[cand]))][: k + 1]
        vals.append(row[order])
        ids.append(order)
    return np.stack(vals), np.stack(ids)


def phase_slice(torch, card):
    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.config import Config, vit_b32_serving
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    cfg = Config(model=vit_b32_serving())
    mc = cfg.model
    t0 = time.perf_counter()
    enc = CLIPEncoder(cfg, seed=0, device="cuda")
    print(f"CLIPEncoder vit_b32_serving on cuda: {mc.vision_layers}+{mc.text_layers} "
          f"layers, widths {mc.vision_width}/{mc.text_width}, "
          f"{time.perf_counter() - t0:.1f} s to build", flush=True)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(N_IMAGES, mc.image_size, mc.image_size, 3),
                          dtype=np.uint8)
    words_a = ["red", "blue", "green", "small", "old", "shiny", "dark", "wet"]
    words_b = ["car", "dog", "house", "tree", "boat", "cat", "bridge", "clock"]
    queries = [f"a photo of a {a} {b}" for a in words_a for b in words_b][:N_CLIENTS]

    # warm-up (first-call costs: weight quantization, cuBLAS handles);
    # its launches are not counted
    enc.encode_pixels(images)
    enc.encode_texts(queries[:8])
    torch.cuda.synchronize()

    # ---- the main path, counted ------------------------------------------
    fa.layer_block_int8.launches = 0
    t0 = time.perf_counter()
    img_emb = enc.encode_pixels(images)
    embed_s = time.perf_counter() - t0
    index = ShardedVectorIndex(dim=mc.embed_dim, config=cfg.index, device="cuda")
    index.insert([f"images/{i:04d}.jpg" for i in range(N_IMAGES)], img_emb)
    grng = np.random.default_rng(1)
    rows = grng.standard_normal((N_ROWS, mc.embed_dim), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index.insert([f"gallery/{i:07d}" for i in range(N_ROWS)], rows, np.ones(N_ROWS, np.float32))
    del rows
    server = SearchServer(enc, index, max_batch=64, max_wait_ms=2.0)
    answers = [None] * N_CLIENTS
    errors = []

    def client(i):
        try:
            answers[i] = server.search(queries[i], top_k=TOP_K, timeout=300)
        except Exception as e:  # reported after the join
            errors.append(repr(e))

    server.start()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(N_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        serve_s = time.perf_counter() - t0
        if any(th.is_alive() for th in threads):
            fail("server clients did not finish")
    finally:
        server.stop()
    launches = fa.layer_block_int8.launches
    # ---- end of the counted run ------------------------------------------
    if errors:
        fail(f"server errors: {errors[:3]}")
    batches = int(server.stats["batches"])
    image_chunks = -(-N_IMAGES // 256)
    expected = mc.vision_layers * image_chunks + mc.text_layers * batches
    print(f"layer_block_int8 launches in the main path: {launches} (expected "
          f"{mc.vision_layers} x {image_chunks} image batch + {mc.text_layers} x "
          f"{batches} text batches = {expected})", flush=True)
    if launches != expected:
        fail("the main path did not run layer_block_int8 once per layer per batch")
    img_per_s = N_IMAGES / embed_s
    qps = N_CLIENTS / serve_s
    print(f"image embed throughput: {img_per_s:.1f} img/s (one batch of {N_IMAGES}, "
          f"uint8 in, embeddings back on the host) [{card}]", flush=True)
    print(f"server: {N_CLIENTS} concurrent clients answered in {serve_s:.3f} s = "
          f"{qps:.1f} QPS over {len(index)} x {mc.embed_dim} f32 rows, "
          f"{batches} micro-batches [{card}]", flush=True)

    # ---- answers vs the float64 oracle -----------------------------------
    path_id = {p: i for i, p in enumerate(index.paths)}
    q_emb = enc.encode_texts(queries)
    ovals, oids = oracle_topk(index.get_vectors(np.arange(len(index))), q_emb, TOP_K)
    worst, swaps = 0.0, 0
    for i, ans in enumerate(answers):
        if ans is None or len(ans) != TOP_K:
            fail(f"query {i}: expected {TOP_K} hits, got {ans!r:.200}")
        sv = np.array([h["score"] for h in ans], np.float64)
        sid = np.array([path_id[h["path"]] for h in ans])
        if not np.isfinite(sv).all():
            fail(f"query {i}: non-finite scores")
        worst = max(worst, float(np.abs(sv - ovals[i, :TOP_K]).max()))
        for r in range(TOP_K):
            gap_prev = np.inf if r == 0 else ovals[i, r - 1] - ovals[i, r]
            gap_next = ovals[i, r] - ovals[i, r + 1]
            if sid[r] != oids[i, r]:
                if min(gap_prev, gap_next) > ORACLE_SCORE_ATOL:
                    fail(f"query {i} rank {r}: id {sid[r]} != oracle {oids[i, r]} "
                         f"with score gaps {gap_prev:.3g}/{gap_next:.3g}")
                swaps += 1
    print(f"server vs float64 oracle: max score diff {worst:.3g} (limit "
          f"{ORACLE_SCORE_ATOL}), ranked ids identical except {swaps} near-tie "
          f"swaps within {ORACLE_SCORE_ATOL}", flush=True)
    if worst > ORACLE_SCORE_ATOL:
        fail("server scores disagree with the oracle")

    # ---- towers on the card vs the same model on CPU tensors -------------
    cpu = CLIPEncoder(cfg, params={k: v.cpu() for k, v in enc.model.state_dict().items()},
                      device="cpu")
    got_i, want_i = torch.from_numpy(img_emb[:8]), torch.from_numpy(cpu.encode_pixels(images[:8]))
    got_t, want_t = torch.from_numpy(q_emb[:8]), torch.from_numpy(cpu.encode_texts(queries[:8]))
    ci, ct = float(row_cos(got_i, want_i).min()), float(row_cos(got_t, want_t).min())
    print(f"towers cuda-kernel vs cpu-plain (bf16, 8 rows): min cos image {ci:.6f}, "
          f"text {ct:.6f} (limit {TOWER_MIN_COS})", flush=True)
    if not (ci >= TOWER_MIN_COS and ct >= TOWER_MIN_COS):
        fail("towers on the card disagree with the CPU towers")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs "
                         "only on a machine with an NVIDIA GPU")
    from image_retrieval_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    build_s = time.perf_counter() - t0
    _build.load_library()
    print(f"kernels from image_retrieval_tpu_torch/csrc built for sm_90a by nvcc "
          f"in {build_s:.1f} s: {os.path.relpath(lib_path)}", flush=True)
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)

    max_err, times = phase_kernels(torch, card)
    launches = phase_slice(torch, card)

    jax_free = "jax" not in sys.modules and not any(
        m.startswith("image_retrieval_tpu.") and m != "image_retrieval_tpu.config"
        for m in sys.modules)
    if not jax_free:
        fail("JAX or a JAX-package module other than its config was imported")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "layer_block_int8",
        "route": "cuda",
        "source": "image_retrieval_tpu_torch/csrc/layer_block_int8.cu",
        "replaces": "image_retrieval_tpu/ops/flash_attention.py:772",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["vision"]["kernel"],
        "plain_ms": times["vision"]["plain"],
        "text_ms": times["text"]["kernel"],
        "text_plain_ms": times["text"]["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
