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
  4. the int4 capacity tier: 2^23 seeded unit rows (16 planted neighbours
     per text query of phase 3, cosines 0.3-0.95) with a `bucket` attribute
     go into IndexConfig(dtype="int4", rerank_c=128) in chunks of 2^20 (2 GiB
     of packed rows on the card); SearchServer answers the 64 queries at
     top-10, TextImageSearcher answers three filtered ones, and a second
     index in latency mode (rerank_device=True) over the same rows answers
     the same queries. Every answer is held against a float64 int8-exact
     oracle computed on the card from the index's host int8 rows, for the
     exact query each search was given; the int4 screen kernel's launch
     counter must show one launch per 2^21-row segment per search. Then the
     kernel against its plain version on one segment, at Q = 1 and 64.

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
# Phase 4: gallery rows, insert chunk, planted neighbours per query, the
# screen's candidates per query, single-query latency samples.
N4, CHUNK4, PLANTED4, RERANK_C, N_SINGLE = 1 << 23, 1 << 20, 16, 128, 50
INT4_ORACLE_ATOL = 1e-5  # f32 rerank vs float64 int8-exact oracle, same bf16 query
LATENCY_ATOL = 1e-6  # latency mode vs capacity mode, same rows and queries
RECALL_MIN = 0.99  # recall@10 of the two-phase tier vs the oracle's top-10


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


def serve_wave(server, queries):
    """One wave of concurrent clients, one per query, through `server`.
    Returns (answers, seconds, micro-batches)."""
    answers = [None] * len(queries)
    errors = []

    def client(i):
        try:
            answers[i] = server.search(queries[i], top_k=TOP_K, timeout=300)
        except Exception as e:  # reported after the join
            errors.append(repr(e))

    batches = server.stats["batches"]
    server.start()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(queries))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        seconds = time.perf_counter() - t0
        if any(th.is_alive() for th in threads):
            fail("server clients did not finish")
    finally:
        server.stop()
    if errors:
        fail(f"server errors: {errors[:3]}")
    return answers, seconds, int(server.stats["batches"] - batches)


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
    answers, serve_s, batches = serve_wave(server, queries)
    launches = fa.layer_block_int8.launches
    # ---- end of the counted run ------------------------------------------
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
    return launches, enc, queries, q_emb

def recording_index(base):
    """A ShardedVectorIndex that keeps every search's stage label, query
    batch, filter and answer, so the oracle scores exactly the queries the
    index was given."""

    class RecordingIndex(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.stage, self.calls = None, []

        def search(self, queries, *args, **kwargs):
            out = super().search(queries, *args, **kwargs)
            self.calls.append((self.stage, np.array(queries, np.float32, ndmin=2),
                               kwargs.get("flt"), [np.atleast_2d(a) for a in out]))
            return out

    return RecordingIndex


def planted_rows(q_emb, rng):
    """PLANTED4 rows per query, normalize(q_hat + sigma * noise) with sigma
    set for cosines spread over 0.3-0.95, at distinct seeded positions."""
    qhat = q_emb / np.linalg.norm(q_emb, axis=1, keepdims=True)
    nq, d = qhat.shape
    rho = rng.uniform(0.3, 0.95, size=(nq, PLANTED4, 1))
    sigma = np.sqrt((1.0 / rho ** 2 - 1.0) / d)
    rows = qhat[:, None, :] + sigma * rng.standard_normal((nq, PLANTED4, d))
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    pos = rng.choice(N4, size=nq * PLANTED4, replace=False)
    return pos, rows.reshape(-1, d).astype(np.float32)


def gallery_chunk(torch, c, d, pos, planted):
    """Chunk c of the seeded unit gallery (made on the card), with the
    planted rows that fall inside it."""
    g = torch.Generator(device="cuda").manual_seed(1000 + c)
    rows = torch.randn((CHUNK4, d), generator=g, device="cuda")
    rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    rows = rows.cpu().numpy()
    inside = (pos >= c * CHUNK4) & (pos < (c + 1) * CHUNK4)
    rows[pos[inside] - c * CHUNK4] = planted[inside]
    return rows


def int4_oracle(torch, index, depth):
    """float64 int8-exact scores of every live row for each recorded query
    of `index`: the query normalized by the index's own f32 steps on the
    card and rounded to bf16, times the host int8 rows, times their scales;
    a call filtered by `bucket == 3` sees bucket-3 rows only. Returns, per
    call, the float64 queries and the top-`depth` (scores, ids)."""
    qs, filtered = [], []
    for _, qn, flt, _ in index.calls:
        q = torch.from_numpy(qn).cuda()
        nrm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        qu = torch.where(nrm > 0, q / torch.where(nrm > 0, nrm, 1.0), 0.0)
        qs.append(qu.to(torch.bfloat16).double())
        if flt not in (None, "bucket == 3"):
            fail(f"the oracle knows no filter {flt!r}")
        filtered += [flt is not None] * qn.shape[0]
    qall = torch.cat(qs)
    filtered = torch.tensor(filtered, device="cuda")[:, None]
    live = torch.from_numpy(index.live_mask()).cuda()
    best_v = torch.full((qall.shape[0], depth), float("-inf"), dtype=torch.float64,
                        device="cuda")
    best_i = torch.zeros((qall.shape[0], depth), dtype=torch.int64, device="cuda")
    for lo in range(0, len(index), CHUNK4):
        hi = min(lo + CHUNK4, len(index))
        rows = torch.from_numpy(index._host_gallery[lo:hi]).cuda().double()
        scales = torch.from_numpy(index._host_scales[lo:hi]).cuda().double()
        ids = torch.arange(lo, hi, device="cuda")
        s = (qall @ rows.t()) * scales
        s = s.masked_fill(~live[lo:hi] | (filtered & (ids % 8 != 3)), float("-inf"))
        v, i = torch.topk(s, depth, dim=1)
        v, j = torch.topk(torch.cat([best_v, v], 1), depth, dim=1)
        best_v, best_i = v, torch.gather(torch.cat([best_i, i + lo], 1), 1, j)
    qall, best_i = qall.cpu().numpy(), best_i.cpu().numpy()
    out, r = [], 0
    for _, qn, _, _ in index.calls:
        out.append((qall[r: r + qn.shape[0]], best_i[r: r + qn.shape[0]]))
        r += qn.shape[0]
    return out


def check_int4_answers(index, oracle):
    """Every recorded answer of `index` against the oracle: the returned
    rows' scores within INT4_ORACLE_ATOL of their float64 scores, ranked in
    the oracle's order except swaps within that limit, filtered answers
    from bucket 3 only. Returns the worst score difference and, per stage,
    [answers, misses of the oracle's top-10]."""
    worst, recall = 0.0, {}
    for (stage, _, flt, (vals, idx)), (qs, top) in zip(index.calls, oracle):
        for vrow, irow, q, trow in zip(vals, idx, qs, top):
            if (irow < 0).any() or not np.isfinite(vrow).all():
                fail(f"{stage}: padding in an answer that should be full")
            exact = (index._host_gallery[irow].astype(np.float64) @ q
                     * index._host_scales[irow].astype(np.float64))
            worst = max(worst, float(np.abs(vrow - exact).max()))
            if (np.diff(exact) > INT4_ORACLE_ATOL).any():
                fail(f"{stage}: an answer is not in the oracle's order: {exact}")
            if flt is not None and (irow % 8 != 3).any():
                fail(f"{stage}: a filtered answer left bucket 3: {irow}")
            tally = recall.setdefault(stage, [0, 0])
            tally[0] += TOP_K
            tally[1] += TOP_K - len(set(trow[:TOP_K].tolist()) & set(irow[:TOP_K].tolist()))
    if worst > INT4_ORACLE_ATOL:
        fail(f"scores differ from the oracle by {worst:.3g}")
    return worst, recall


def kernel_vs_plain_int4(torch, card, index, qu64):
    """K3 against its plain version on the first 2^21-row segment of the
    card's packed rows, 1 % of rows invalid, at Q = 1 and Q = 64."""
    from image_retrieval_tpu_torch.ops import int4_screen as k3
    from image_retrieval_tpu_torch.ops.topk import exact_topk_wide

    seg = k3.SEGMENT_ROWS
    packed, scales = index._packed[:seg], index._scales4[:seg]
    g = torch.Generator(device="cuda").manual_seed(7)
    valid = torch.rand(seg, generator=g, device="cuda") >= 0.01
    out = {}
    for nq in (1, 64):
        qu = qu64[:nq].contiguous()
        got = k3.int4_screen_scores(qu, packed, scales, valid)
        want = k3.int4_screen_scores_reference(qu, packed, scales, valid)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), fin):
            fail(f"int4_screen Q={nq}: the -inf pattern differs from the plain version")
        err = float((got[fin] - want[fin]).abs().max())
        got_i = exact_topk_wide(got, RERANK_C)[1].tolist()
        want_v, want_i = exact_topk_wide(want, RERANK_C)
        swaps = 0
        for r in range(nq):
            for j in set(got_i[r]) ^ set(want_i[r].tolist()):
                if abs(float(want[r, j] - want_v[r, -1])) > k3.SCREEN_MAX_ABS:
                    fail(f"int4_screen Q={nq}: top-{RERANK_C} differs away from the boundary")
                swaps += 1
        del got, want
        t = time_pair(torch, {
            "kernel": lambda: k3.int4_screen_scores(qu, packed, scales, valid),
            "plain": lambda: k3.int4_screen_scores_reference(qu, packed, scales, valid),
        })
        print(f"int4_screen kernel-vs-plain Q={nq}, {seg} rows x 512: max_abs_err "
              f"{err:.3g} (limit {k3.SCREEN_MAX_ABS}), top-{RERANK_C} sets identical "
              f"except {swaps} boundary near-ties; kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms [{card}]", flush=True)
        if not err <= k3.SCREEN_MAX_ABS:
            fail(f"int4_screen Q={nq} disagrees with its plain version")
        out[nq] = dict(t, max_abs_err=err)
    return out


def phase_int4(torch, card, enc, queries, q_emb):
    """The int4 capacity tier, counted; then its checks, single-query
    latency, and K3 against its plain version."""
    import dataclasses

    from image_retrieval_tpu_torch.app.search import TextImageSearcher
    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.config import Config, vit_b32_serving
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    d = q_emb.shape[1]
    base = dataclasses.replace(Config(model=vit_b32_serving()).index, embedding_dim=d,
                               dtype="int4", rerank_c=RERANK_C, capacity_step=N4)
    pos, planted = planted_rows(q_emb, np.random.default_rng(4))
    qbatch = q_emb / np.linalg.norm(q_emb, axis=1, keepdims=True)
    Index = recording_index(ShardedVectorIndex)

    # ---- the main path, counted ------------------------------------------
    k3.int4_screen_scores.launches = 0
    cap = Index(dim=d, config=base, device="cuda")
    lat = Index(dim=d, config=dataclasses.replace(base, rerank_device=True), device="cuda")
    t0 = time.perf_counter()
    for c in range(N4 // CHUNK4):
        rows = gallery_chunk(torch, c, d, pos, planted)
        ids = np.arange(c * CHUNK4, (c + 1) * CHUNK4)
        paths = [f"gallery/{i:07d}" for i in ids]
        for ix in (cap, lat):
            ix.insert(paths, rows, np.ones(CHUNK4, np.float32), attrs={"bucket": ids % 8})
        del rows
    insert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cap.load()
    lat.load()
    torch.cuda.synchronize()
    print(f"int4 tier: {len(cap)} x {d} rows inserted into two indexes in {insert_s:.1f} s "
          f"(host quantization), uploaded in {time.perf_counter() - t0:.1f} s; on the card "
          f"capacity mode holds {cap._packed.numel() / 2**30:.2f} GiB of packed rows, "
          f"latency mode {lat._packed.numel() / 2**30:.2f} GiB + "
          f"{lat._gallery.numel() / 2**30:.2f} GiB of int8 rows [{card}]", flush=True)
    waves = {}
    for name, ix in (("capacity", cap), ("latency", lat)):
        ix.stage = "warm-up"  # first-call costs (allocator, cuBLAS handles)
        ix.search(qbatch[:8], top_k=TOP_K)
        ix.stage = "wave"
        server = SearchServer(enc, ix, max_batch=64, max_wait_ms=2.0)
        # a cold wave (first micro-batch shapes), then the same wave again
        waves[name] = [serve_wave(server, queries) for _ in range(2)]
    cap.stage = "filtered"
    searcher = TextImageSearcher(enc, cap)
    filtered = [searcher.search(queries[i], top_k=TOP_K, score_threshold=-1.0,
                                filter_expr="bucket == 3") for i in (0, 1, 2)]
    cap.stage = lat.stage = "batch"
    vc, ic = cap.search(qbatch, top_k=TOP_K)
    vl, il = lat.search(qbatch, top_k=TOP_K)
    launches = k3.int4_screen_scores.launches
    # ---- end of the counted run ------------------------------------------
    segments = -(-N4 // k3.SEGMENT_ROWS)
    searches = len(cap.calls) + len(lat.calls)
    print(f"int4_screen launches in the main path: {launches} (expected {segments} "
          f"segments x {searches} index searches = {segments * searches})", flush=True)
    if launches != segments * searches:
        fail("the int4 tier did not run the screen kernel once per segment per search")
    lat_diff = float(np.abs(vc - vl).max())
    if not np.array_equal(ic, il) or lat_diff > LATENCY_ATOL:
        fail(f"latency mode answers differ from capacity mode (score diff {lat_diff:.3g})")
    for name, both in waves.items():
        ix = cap if name == "capacity" else lat
        seen = {tuple((f"gallery/{i:07d}", float(v)) for v, i in zip(vr, ir))
                for stage, _, _, (vals, idx) in ix.calls if stage == "wave"
                for vr, ir in zip(vals, idx)}
        for answers, _, _ in both:
            for a in answers:
                if a is None or tuple((h["path"], h["score"]) for h in a) not in seen:
                    fail(f"{name}: a client's answer is not what the index returned")
    for a in filtered:
        if len(a) != TOP_K or any(int(h["path"][8:]) % 8 != 3 for h in a):
            fail(f"filtered search returned {a!r:.200}")

    worst = {}
    for name, ix in (("capacity", cap), ("latency", lat)):
        worst[name], recall = check_int4_answers(ix, int4_oracle(torch, ix, 3 * TOP_K))
        for stage, (n, misses) in recall.items():
            print(f"int4 {name} mode, {stage}: recall@10 vs the oracle "
                  f"{1 - misses / n:.4f} over {n} answers ({misses} misses; limit "
                  f"{RECALL_MIN}) [{card}]", flush=True)
            if 1 - misses / n < RECALL_MIN:
                fail(f"{name} {stage}: recall@10 below {RECALL_MIN}")
    print(f"int4 tier vs float64 int8-exact oracle: max score diff capacity "
          f"{worst['capacity']:.3g}, latency {worst['latency']:.3g} (limit "
          f"{INT4_ORACLE_ATOL}); latency mode ids equal capacity mode's, scores within "
          f"{lat_diff:.3g} (limit {LATENCY_ATOL}) [{card}]", flush=True)

    latency = {}
    for name, ix in (("capacity", cap), ("latency", lat)):
        for i in range(3):
            ix.search(qbatch[i], top_k=TOP_K)
        ms = []
        for i in range(N_SINGLE):
            t0 = time.perf_counter()
            ix.search(qbatch[i], top_k=TOP_K)
            ms.append((time.perf_counter() - t0) * 1e3)
        latency[name] = float(np.median(ms))
        (_, cold, cold_b), (_, warm, warm_b) = waves[name]
        print(f"int4 {name} mode over {N4} rows: single-query top-{TOP_K} p50 "
              f"{latency[name]:.3f} ms ({N_SINGLE} queries, host clock); wave of "
              f"{N_CLIENTS} concurrent text queries through SearchServer: cold "
              f"{N_CLIENTS / cold:.1f} QPS ({cold_b} micro-batches), again "
              f"{N_CLIENTS / warm:.1f} QPS ({warm_b} micro-batches) [{card}]", flush=True)
    qu64 = torch.from_numpy(qbatch).cuda()
    qu64 = (qu64 / torch.linalg.vector_norm(qu64, dim=-1, keepdim=True)).to(torch.bfloat16)
    kernel = kernel_vs_plain_int4(torch, card, cap, qu64)
    return launches, kernel


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
    launches, enc, queries, q_emb = phase_slice(torch, card)
    int4_launches, k3 = phase_int4(torch, card, enc, queries, q_emb)

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
    }, {
        "name": "int4_screen",
        "route": "cuda",
        "source": "image_retrieval_tpu_torch/csrc/int4_screen.cu",
        "replaces": "image_retrieval_tpu/ops/pallas_kernels.py:602",
        "launches": int4_launches,
        "max_abs_err": max(k3[1]["max_abs_err"], k3[64]["max_abs_err"]),
        "ms": k3[64]["kernel"],
        "plain_ms": k3[64]["plain"],
        "q1_ms": k3[1]["kernel"],
        "q1_plain_ms": k3[1]["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
