#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and search paths once on one GPU.

    python3 chip_smoke.py                   # needs one CUDA card and nvcc
    python3 chip_smoke.py --time-k1         # build, then only K1's, K2a's and K2b's
                                            # times and K1's launch breakdown (phase 2)
    python3 chip_smoke.py --dense-readings  # build, then what dense_agreement reads
                                            # for K8, K9a, K9b and for wrong layers
    python3 chip_smoke.py --gemm-stages     # build, then only the GEMM stages alone:
                                            # q/k/v and out-projection of K9a, fc1 and
                                            # fc2 of K9b and K2b (phase 2), and K2b's
                                            # fused fc1 -> quick_gelu -> rowquant
    python3 chip_smoke.py --time-dense      # build, then only K8, K9a and K11 timed
                                            # (event and device time), K8's and K9a's
                                            # launch breakdown, the four bf16 stages
    python3 chip_smoke.py --gemm-variants   # build and run the bf16 GEMM's design
                                            # experiments (csrc/experiments/
                                            # gemm_bf16_variants.cu)
    python3 chip_smoke.py --rowquant-variants  # build and run the design experiments of
                                            # K2b's fused fc1 -> quick_gelu -> rowquant
                                            # (csrc/experiments/rowquant_gemm_variants.cu)
    python3 chip_smoke.py --time-metrics    # build, then only the metric kernels K4-K7:
                                            # registers, vs plain at the f32 sweep's
                                            # edges, times (event and device) at Q = 1
                                            # and 64, the int8 tier's multi-metric call
    python3 chip_smoke.py --time-k3         # build, then only K3 and K12 (the int4
                                            # screen): registers, vs plain, times at
                                            # Q = 1, 8, 64, a segment's breakdown
    python3 chip_smoke.py --k3-variants     # the int4 screen's design against the
                                            # variants it was chosen over, in turns
    python3 chip_smoke.py --durable         # build, then only phase 9 on the encoders
                                            # and the gallery phases 3 and 5 would give it
    python3 chip_smoke.py --tiers           # build, then only phase 10 on the encoder
                                            # and the gallery phases 5 and 6 would give it
    python3 chip_smoke.py --ivf             # build, then only phase 11 on the encoder
                                            # and the gallery phases 3 and 6 would give it
    python3 chip_smoke.py --analysis        # build, then only phase 12 (its own dataset
                                            # and encoders)

Phases (any failure exits non-zero):
  1. card and build: the card's name and power limit (nvidia-smi), then the
     port's kernels compiled from image_retrieval_tpu_torch/csrc with nvcc
     for sm_90a (one nvcc per source, twelve in parallel); ptxas's registers
     and spills of the bf16 GEMM, the compute-type LayerNorm pass, the fused
     fc1 stage and the int8 row pass (a spill fails).
  2. kernel vs plain: layer_block_int8 (K1), attention_block_int8 (K2a) and
     mlp_block_int8 (K2b) on the card against their plain PyTorch versions
     on the same inputs, in bf16 and f32, by kernel_agreement: K1 at the
     ViT-B/32 tower shapes (B=8 T=50 W=768 12 heads; B=8 T=77 W=512 8 heads,
     causal) and at the ViT-B/16 shape (B=4 T=197 W=768), K2a and K2b at the
     ViT-L/14 vision shape (B=4 T=257 W=1024 16 heads) and at the two B/32
     shapes; K2a then K2b against K1 at (8, 50, 768), bitwise; QuantDense
     against its plain version; the MLP half's fc1 -> quick_gelu -> rowquant
     (one clustered GEMM launch) against its plain version bit for bit at
     every hidden width of the main paths (2048, 3072, 4096), with its plan
     and the clusters the card holds at once. Then timings (CUDA events,
     medians of samples taken in turns plain/kernel/kernel/plain) at B=8 and
     at the main paths' batches, each beside the least time the card could
     take for the work, and the device time of each launch kind of K1 at
     B/32 vision B=256 and of K2a + K2b at the L/14 image batch
     (torch.profiler).
     The same for the kernels in the compute dtype: layer_block (K8),
     attention_block (K9a), mlp_block (K9b) and multihead_attention (K10)
     against their plain versions in bf16 and f32 at the four tower shapes and
     a ragged one (3, 13, 128, causal), by dense_agreement per part of a
     layer (K10: by a max-abs limit); K9a then K9b against K8, bitwise, at
     both B/32 shapes; their times at B=8, at the B/32 batches (vision B=256,
     text B=64) and at the L/14 batch (B=128), K9b also at the trainer's
     batch (B/32 vision B=128), K2b also at B/32 vision B=8 and 256, and for
     K10 the time of one scaled_dot_product_attention call on the same q, k,
     v beside it (at the B/32 vision B=8 and B=256 and L/14 vision B=128
     shapes, and at the B/32 text B=64 shape with the causal mask, through
     the packed tiled_attention entry and is_causal=True).
     The GEMM stages alone (the GEMMs of csrc/gemm_sm90.cuh through
     gemm_bf16 / gemm_s8, with the epilogues their chains give them): q/k/v
     and the out-projection of K9a, fc1 and fc2 of K9b and K2b, at the L/14
     vision B=128 and B/32 vision B=256 shapes: each against its plain
     version (int8 bit for bit, bf16 by
     gemm_bf16_agreement's float64 limit), its time beside the plain
     version's, the bound's and one library call's on the same operands
     (torch.nn.functional.linear in bf16, torch._int_mm in int8; the port
     never calls either), and the device time alone; K2b's fused fc1 ->
     quick_gelu -> rowquant the same way, also in turns with the two
     launches it replaces (fc1 writing f32, then the rowquant pass).
     attention_block_train's saving forward (K11) against its plain version
     in bf16 and f32 at both B/32 shapes, at B = 8 and at B = 128 (the
     trainer's batch), and at the ragged one: the five outputs in the compute
     dtype by dense_agreement, the f32 probabilities by a max-abs limit with
     exact zeros above a causal diagonal, its output against K9a's bit for
     bit; its times at B = 128 beside K9a's, the plain version's and the
     bound.
  3. the ViT-B/32 slice: CLIPEncoder(vit_b32_serving, seed 0) at full width
     on the card encodes 256 seeded uint8 images; they and 1,000,000 seeded
     unit rows go into the f32 ShardedVectorIndex; SearchServer answers 64
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
     kernel against its plain version on one segment, at Q = 1 and 64, its
     times beside the plain version's and the bound. The int8-query screen
     (K12) on the same segment against its plain version, bit for bit, its
     times beside K3's; then, counted, one int4_screen_topc(qform="i8")
     sweep over the 2^23 rows (one K12 launch per segment) whose top-128 is
     held against the bf16 sweep's by recall. --time-k3 runs the screens
     alone on a seeded segment of the same shape: ptxas's registers and
     spills of every screen kernel (a spill fails), K3 and K12 against their
     plain versions at Q = 1, 8 and 64 with their times, device times and
     bounds, and where a segment's time goes (the screen, the selection
     segmented_topc runs on its plane, the latency mode's rerank).
  5. the ViT-L/14 slice: CLIPEncoder(serving_config(vit_l14()), seed 0) at
     full width (24 + 12 layers, widths 1024 / 768, embedding 768), on the
     card by default, encodes 64 seeded uint8 images (one batch, padded to
     the encoder's 128 bucket: 32,896 token rows); they and 2^20 seeded 768-d
     unit rows (planted neighbours as in phase 4) go into the int8 tier of an
     ImageEmbeddingSystem's index; SearchServer answers 64 concurrent text
     queries at top-10 and TextImageSearcher four single ones, every answer
     held against the float64 oracle over the index's host int8 rows. The
     launch counters must show 24 K2a + 24 K2b launches per image batch and
     12 K1 launches per text batch. Then every block of both towers on the
     card against its plain version on the same card, on the same input, and
     the plain chain against the kernel chain (TOWER_MIN_COS); and a
     torch.profiler window over one image batch: device time by kernel.

  6. the weighted and multi-metric path: the f32 gallery of phase 3 and the
     int8 gallery of phase 5 (seeded magnitudes in [0.5, 4], a `bucket`
     attribute) get, per text query, one row equal to the query's embedding
     and 16 planted neighbours. Counted: SearchServer answers one wave of
     72 concurrent requests with metric="optimized_similarity": the 64
     queries under weights (1, 1, 1, 0, 0.5), the last 16 of them under a
     filter, and 8 more under a second weight set, so that a micro-batch
     holds several (metric, weights, filter) groups; on the int8 tier (the
     int8 weighted kernel K5: one launch per group, held against the
     server's count of groups) and on the f32 tier (tensor operations,
     direct L2); multi_metric_topk on both
     tiers with and without the filter (the five-plane kernel K6: one launch
     per f32 call, one per 2^16-row block of the int8 tier); an ascending
     search (l1_distance), also under a 4-row mask (+inf, -1 padding);
     scores() of 2048-row indexes; search_with_multiple_metrics; and the
     ops-level entries fused_optimized_topk (K4) and fused_optimized_scores
     (K7) over the whole f32 gallery. Every answer is held against a float64
     oracle computed on the card from the index's host rows (for the int8
     weighted score by the int8 scorer's definition: bf16 query, bf16
     differences). Then K7, K6, K4 (k = 10 and 64, f32 and bf16 rows, a
     ragged row count, and rows that score -inf) and K5 (D = 768 and 512)
     against their plain versions on 2^18 rows at Q = 1 and 64 by the limits
     of ops/fused_metrics.py, and
     their times over the whole galleries beside the plain versions' and the
     bounds (K5 also beside its bound as counted before its L1 sum moved to
     the tensor cores, with its share of the bound and, from ptxas in
     build.log, the registers and spills of its instantiations).

  7. the encoder under the flags that select the compute-dtype kernels, in
     bf16. A, CLIPEncoder(replace(vit_b32(), fused_layer_block=True), seed
     0), whole: the 256 images and 1,000,000 rows of phase 3 into a new f32
     index, SearchServer answers the 64 queries, each held against the
     float64 oracle; K8's counter must show 12 launches per image batch and
     12 per text batch and no other kernel of the family; every block against
     its plain version and the towers against the plain route vit_b32() by
     row cosine. C, replace(vit_b32(), pallas_attention=True): one image
     batch (12 K10 launches) and one text batch (none), towers against the
     plain route. B, replace(vit_l14(), fused_layer_block=True): 64 images
     padded to 128 (24 K9a + 24 K9b launches), one wave of 64 queries over
     phase 5's int8 gallery (12 K8 launches per text batch) against the
     int8-exact oracle, every block against its plain version, and a
     torch.profiler window over the image batch.

  8. the trainer at full width: CLIPTrainer(replace(vit_b32(),
     fused_attn_block=True, fused_mlp_block=True, fused_train_vjp=True), seed
     0) on the card in bf16, at the trainer's default learning rate, takes a
     warm step and then ten counted steps
     through fit() on one repeated batch of 128 seeded image/token pairs (K11
     and K9b: 24 launches a step each), then embeds the batch without
     gradients (K9a and K9b: 24 each). Beside it the same steps from the same
     seed under plain vit_b32(), autograd through the unfused route. Every
     loss must be finite, the first near ln 128, the last lower, the first
     HELD_STEPS losses of the two curves within TRAIN_LOSS_ATOL (later the
     loss collapses and the curves are printed, not held); the gradients of
     one step through the
     kernels are held against the same step through the plain versions on
     the card by cosine per parameter. Then the time of K11's hand-written
     backward beside the backward that recomputes through the plain version.

  9. the durable ingest-and-serve slice, run after phase 6 while phase 3's
     and phase 5's encoders and phase 3's gallery are on the card. 4,096
     seeded 640 x 480 JPEGs in three subfolders go through the port's CLI,
     cli.main(["search", "--folder", ..., "--fast_encoder", "--journal_dir",
     J, query]): ImageSearchApp, encode_folder, the encoder's chunks in
     flight; K1's counter must show 12 launches per encoded batch (image and
     text), and the embeddings must equal phase 3's encoder's with a window
     of one chunk, bit for bit. `compare` on the same folder and journal:
     one K6 launch, its five lists against the float64 oracle. A child
     process (chip_smoke.py --durable-child) opens J, ingests 512 more JPEGs
     and removes 256 paths through SearchServer while 64 text and 16 image
     queries are served, answers them again and kills itself with SIGKILL,
     without a checkpoint; the parent reopens J: every acknowledged insert
     present, every acknowledged delete absent, the 80 answers against the
     child's and the float64 oracle, each image query's own path excluded.
     The web UI over the reopened index answers /search and /similar over
     HTTP as the server does. tests/data/jax_journal_int8 (a journal the JAX
     package wrote) reopens with the JAX index's answers. Phase 3's
     1,000,256 x 512 rows go into a journaled index: checkpoint, 65,536 more
     rows, open, save, load_from, each timed, the answers of 64 queries
     against the oracle. Last, the card's idle share over encode_stream of 8
     L/14 int8 batches of 128 images with the window of four and of one
     (torch.profiler: the union of the kernels' and copies' intervals).

 10. the tiers beyond the resident sweep, run after phase 9 while phase
     5's encoder and gallery (with phase 6's planted rows) are on the card.
     On that int8 gallery: approx_select=True (answers bit for bit the exact
     selector's); l1_shadow=True (no shadow built: the weighted answers
     under (1, 1, 1, 0, 0.5) through K5 against the int8 scorer's float64
     oracle by phase 6's limits; the shadow scorer's time and memory beside
     K5's); ScreenedSearch (pca, 128 dims, 128 candidates): build time,
     latency, recall@10 against the exact tier (>= 0.9), a pool of every row
     on a 2^16-row slice giving the exact answers, SearchServer(ann=screen)
     answering 64 concurrent queries with what the screen returns, and an
     insert detaching the screen (the row is then deleted and compacted away,
     so the later phases see phase 5's gallery). Then 2^24
     seeded 512-d unit rows (16 planted per query of phase 3) are quantized
     on the host in 2^22-row pieces into an int8 and an int4 index past
     their stream_threshold_bytes (8 GiB of pinned int8 rows, 4 GiB of
     pinned packed rows), streamed in 2^22-row chunks. Counted: a batch of
     64 queries and 4 single ones, unfiltered and under a filter, on both,
     then after 4,096 deletes, then after compact; K3 must show one launch
     per 2^21-row segment of each packed chunk per search. Every answer
     against the float64 int8-exact oracle (int4: recall@10 >= 0.99), the
     int8 answers against the resident int8 tier over the same rows within
     1e-6. K3 against its plain version on a streamed chunk's segment; each
     sweep timed beside one chunk's upload (GB/s) and one chunk's sweep on
     the card, and expected_sweep_seconds from the two; the streamed screen
     over the int8 index (recall@10 >= 0.9, latency); MemAvailable.

 11. the IVF tier and the planner, run after phase 10 (its pinned rows
     freed) on phase 3's encoder and f32 gallery with phase 6's planted rows.
     A, the reference's deployment: IVFIndex.from_index(nlist=1024,
     nprobe=10) over the f32 rows, its build timed in parts;
     SearchServer(ann=ivf) answers 64 concurrent text queries (K1 counted:
     12 launches a text batch) and TextImageSearcher(ann=ivf) four single
     ones; every (score, id) against the float64 cosine of its row (1e-5)
     and inside one of its query's probed clusters; recall@10 against the
     exact f32 tier where the exact top-10 are planted rows (>= 0.9); p50
     latencies beside the exact tier's; then 256 seeded JPEGs inserted
     through SearchServer.add_images (the IVF stays attached, each of 16 is
     its own best hit through the tail) and 256 rows removed (never returned
     in a second wave). B, the operating point: 2^23 seeded clustered unit
     rows (4,096 planted clusters, made on the card), recommended_ivf(2^23)
     = (4096, 8) over int8 slabs with train_size 512k, the build timed in
     parts and lmax printed; recall@10 and p50 latencies of one and of 64
     queries against the exact int8 tier over the same rows; offload() (the
     same answers bit for bit, the bytes uploaded for a 64-query batch),
     save and load (the same answers). C, the planner: usable device memory,
     the card's time for one query over 2^20 x 512 rows in f32, bf16, int8
     and int4 (torch.profiler; the host clock's p50 printed beside it),
     the int8 sweep rate at Q = 64 over B's gallery and the upload rate
     (phase 10's), each beside index/plan.py's constant (more than 25% off
     fails the phase once everything is printed); `cli plan` for 2^20, 2^23,
     2^25 and 2^27 rows; tests/data/jax_ivf_int8.npz (an IVF the JAX package
     saved) loaded on the card, resident and offloaded, answering as the JAX
     package did.
 12. the color-analysis slice, run after phase 11 on its own dataset and
     encoders (seeded B/32 weights, full width). A: prepare_color_dataset
     builds 600 synthetic images (10 categories x 3 colours x 20) and their
     179,700 relationship pairs; dominant_colors_batch (batched k-means) on
     the card and on the CPU over the 600 JPEGs must name the same colours.
     B: run_workflow over that dataset under vit_b32_serving() (K1 counted:
     12 launches an image batch) and under plain vit_b32(); every image's
     embedding at row cosine >= 0.999 between the two, their results.json
     printed side by side. C: on B's npz ColorMIAnalyzer(precision="device")
     (f32 pair_metrics on the card) against precision="strict" (host
     float64): the tables within 1e-5 + 1e-5 |v|, general and colour MI
     within 5e-3; the host grid search of optimize_weights(grid_size=3) timed
     (analysis_grid_ms), then discretize_uniform / mutual_info_uniform over
     its 243 combinations on the card against the CPU (bins equal, MI within
     1e-5). D: the CLI's `analyze --synthetic` (150 images) and, over A's
     folder with --fast-encoder (K1 counted), `mi` and `geometric --optimize
     --grid-size 3 --ci` (with --plot where matplotlib is installed; the
     card's machine has none, so the analyses there write results.json
     without the plots). Prints each part's seconds and K1's launches.

Prints the card line, a JSON line of per-kernel results (times and the
bound at the main path's shapes), and, last, the {"ok": true, "device": ...}
line. Imports no JAX and nothing of the JAX package.
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
TOWER_MIN_COS = 0.999  # the towers through the kernels vs through the plain versions
ORACLE_SCORE_ATOL = 1e-5  # f32 sweep vs float64 oracle, unit rows, D = 512
N_IMAGES, N_ROWS, N_CLIENTS, TOP_K = 256, 1_000_000, 64, 10
# Phase 4: gallery rows, insert chunk, planted neighbours per query, the
# screen's candidates per query, single-query latency samples.
N4, CHUNK4, PLANTED4, RERANK_C, N_SINGLE = 1 << 23, 1 << 20, 16, 128, 50
# Phase 5: images (one encoder batch, padded to the 128 bucket), gallery
# rows, single searches through TextImageSearcher, images of the tower check.
N_IMAGES5, ENC_BUCKET5, N5, N_SINGLE5, N_CHECK5 = 64, 128, CHUNK4, 4, 4
INT4_ORACLE_ATOL = 1e-5  # f32 sums vs float64 int8-exact oracle, same bf16 query
K3_QUERIES = (1, 8, 64)  # --time-k3: a single query, a few, a SearchServer micro-batch
LATENCY_ATOL = 1e-6  # latency mode vs capacity mode, same rows and queries
RECALL_MIN = 0.99  # recall@10 of the two-phase tier vs the oracle's top-10
# The int8-query screen against the bf16-query screen over the same rows:
# share of the bf16 sweep's top-128 that the i8 sweep's top-128 holds (around
# the 128th of 2^23 scores neighbours lie 1e-4 apart, the int8 query grid
# moves a score by a few 1e-4: ranks near the boundary swap), and of its
# top-10 (the planted neighbours, far from the boundary).
I8_TOP128_MIN, I8_TOP10_MIN = 0.95, 1.0
# Phase 8, at the trainer's default learning rate: pairs in the batch, counted
# steps, the leading losses (the warm step's included) over which the two
# routes are held together, and by how much. On a repeated batch of seeded
# noise the loss falls slowly for eight steps, then by 0.5-1 a step, then
# rebounds, and a rounding difference between two bf16 routes grows with the
# slope: the routes read within 0.001 over the first eight losses and 0.067
# apart at the eleventh, so the limit holds the slow stretch and the whole
# curves are printed. Then |first loss - ln(pairs)| and the cosine of each
# parameter's gradient through the kernels vs through the plain versions.
N_PAIRS, TRAIN_STEPS, HELD_STEPS = 128, 10, 8
FIRST_LOSS_ATOL, TRAIN_LOSS_ATOL, GRAD_MIN_COS = 0.3, 0.005, 0.99
# f32 probabilities, kernel vs plain (tests/test_torch_gpu.py): sum order and
# expf in f32; in bf16 a q or k value that rounds to its neighbour moves a score
PROBS_ATOL = {"float32": 1e-6, "bfloat16": 2e-2}


# Published dense peaks of one H100 SXM (NVIDIA's data sheet): the bound of
# a kernel is the larger of its operations over the peak for their type and
# its bytes (every input read once, every output written once) over the
# memory rate.
PEAK_INT8_OPS, PEAK_BF16_FLOPS, PEAK_BYTES = 1979e12, 989e12, 3.35e12
# f32 outside the tensor cores: 67 TFLOP/s counts an FMA as two operations,
# so the CUDA cores complete 33.5e12 f32 operations a second, an FMA, a
# subtract, an add or a max each taking one slot.
PEAK_F32_SLOTS = 67e12 / 2
# TF32 on the tensor cores (H100 SXM, dense): the split-TF32 products of the
# f32 metric sweep (K4, K6, K7) run at this rate.
PEAK_TF32_FLOPS = 495e12
# bf16 outside the tensor cores is packed two to a lane (NVIDIA's H100
# architecture paper: 133.8 TFLOP/s, an FMA counted twice), so a bf16
# subtract or max of one element takes half an f32 slot.
BF16_SLOT = 0.5


def fail(msg: str):
    raise RuntimeError(f"chip_smoke FAILED: {msg}")


def bound(int8_ops: float, bf16_flops: float, nbytes: float, f32_slots: float = 0.0,
          tf32_flops: float = 0.0) -> dict:
    """The least time the card could take: {"bound_ms", "bound_by"}."""
    ops_ms = (int8_ops / PEAK_INT8_OPS + bf16_flops / PEAK_BF16_FLOPS
              + f32_slots / PEAK_F32_SLOTS + tf32_flops / PEAK_TF32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def block_bound(kind: str, x, wts, heads: int, causal: bool, int8: bool = True) -> dict:
    """Bound of one call of a layer kernel or one of its halves on these
    inputs. Operations: the projections (2 per multiply-add: 8 W^2 per token
    in the attention half, 4 W hidden in the MLP half) at the int8 peak for
    K1 / K2a / K2b, at the bf16 peak for K8 / K9a / K9b, and the attention's
    QK^T and PV (4 hd per query-key pair and head; with the causal mask only
    the pairs j <= i) at the bf16 peak. Bytes: x, the output, and every
    weight, scale and bias tensor once."""
    b, t, w = x.shape
    m = b * t
    pairs = t * (t + 1) // 2 if causal else t * t
    proj = flops = 0.0
    if kind in ("layer", "attn"):
        proj += 8.0 * w * w * m
        flops += 4.0 * b * pairs * w
    if kind in ("layer", "mlp"):
        proj += 4.0 * w * wts.hidden * m
    nbytes = 2 * x.numel() * x.element_size() + sum(
        a.numel() * a.element_size() for a in wts.tensors())
    return bound(proj, flops, nbytes) if int8 else bound(0.0, proj + flops, nbytes)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def row_cos(a, b):
    a = a.reshape(-1, a.shape[-1]).double()
    b = b.reshape(-1, b.shape[-1]).double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-30))


def layer_params(torch, w, rng, scale=1.0):
    """Seeded f32 layer parameters at the CLIP-like scales of
    models/weights.py init_params (the weight matrices times `scale`), in the
    order of quantize_layer and prepare_layer, on the card."""
    nrm = lambda std, *s: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32))
    in_std = scale * w ** -0.5 * 24 ** -0.5
    params = [1.0 + nrm(0.02, w), nrm(0.02, w),
              nrm(in_std, w, w), nrm(0.02, w), nrm(in_std, w, w), nrm(0.02, w),
              nrm(in_std, w, w), nrm(0.02, w), nrm(scale * w ** -0.5, w, w), nrm(0.02, w),
              1.0 + nrm(0.02, w), nrm(0.02, w),
              nrm(scale * (2 * w) ** -0.5, w, 4 * w), nrm(0.02, 4 * w),
              nrm(in_std, 4 * w, w), nrm(0.02, w)]
    return [p.cuda() for p in params]


def layer_inputs(torch, b, t, w, heads, seed):
    """Seeded int8 layer weights and an f32 input of unit scale (on the host)."""
    from image_retrieval_tpu_torch.ops.flash_attention import quantize_layer

    rng = np.random.default_rng(seed)
    wts = quantize_layer(*layer_params(torch, w, rng))
    return torch.from_numpy(rng.standard_normal((b, t, w)).astype(np.float32)), wts


def time_pair(torch, fns, samples=24, reps=5, warm=3):
    """Median ms per call of each fn; samples taken in turns
    plain/kernel/kernel/plain, each the mean of `reps` back-to-back calls
    between CUDA events, after `warm` calls of each."""
    def one(fn):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    for fn in fns.values():
        for _ in range(warm):
            fn()
    torch.cuda.synchronize()
    got = {k: [] for k in fns}
    for _ in range(samples // 2):
        for k in ("plain", "kernel", "kernel", "plain"):
            got[k].append(one(fns[k]))
    return {k: float(np.median(v)) for k, v in got.items()}


def device_ms(torch, fn, calls=20):
    """Device time of one call of fn: the kernels' self time under
    torch.profiler over `calls` calls, divided by `calls` (no host time and
    no gaps between launches), after three warm calls; None when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA")
    return total / 1e3 / calls if total > 0 else None


def _agree(fa, torch, name, case, got, want, x):
    """kernel_agreement of one case, printed; fails the run if it is not ok."""
    torch.cuda.synchronize()
    r = fa.kernel_agreement(got, want, x)
    print(f"kernel-vs-plain {name} {case} {str(x.dtype)[6:]}: max_abs_err "
          f"{r['max_abs_err']:.6g} (limit {r['max_abs_limit']:.6g}), "
          f"{r['flip_share']:.4%} of elements off by > {fa.AGREE_FLIP_ATOL} "
          f"(limit {fa.AGREE_FLIP_SHARE:.0%}), min per-token cos of the "
          f"update {r['min_update_cos']:.8f} (limit "
          f"{fa.AGREE_MIN_UPDATE_COS})", flush=True)
    if not r["ok"]:
        fail(f"{name} {case} {x.dtype} disagrees with its plain version")
    return r["max_abs_err"]


def dense_layer_inputs(torch, b, t, w, heads, seed, dtype, scale=1.0):
    """The same seeded parameters prepared for the kernels in the compute
    `dtype`, and an input of unit scale in that dtype on the card."""
    from image_retrieval_tpu_torch.ops.flash_attention import prepare_layer

    rng = np.random.default_rng(seed)
    wts = prepare_layer(*layer_params(torch, w, rng, scale), dtype=dtype)
    x = torch.from_numpy(rng.standard_normal((b, t, w)).astype(np.float32))
    return x.to(device="cuda", dtype=dtype), wts


def dense_runs(fa):
    """As kernel_runs, for the kernels in the compute dtype."""
    return {
        "layer_block": (
            lambda x, w, h, c: fa.layer_block(x, w, h, c),
            lambda x, w, h, c: fa.layer_block_reference(x, w, h, c), "layer"),
        "attention_block": (
            lambda x, w, h, c: fa.attention_block(x, w.attn, h, c),
            lambda x, w, h, c: fa.attention_block_reference(x, w.attn, h, c), "attn"),
        "mlp_block": (
            lambda x, w, h, c: fa.mlp_block(x, w.mlp),
            lambda x, w, h, c: fa.mlp_block_reference(x, w.mlp), "mlp"),
    }


RAGGED = (3, 13, 128, 2, True)


def dense_readings(torch):
    """--dense-readings: what dense_agreement reads between each compute-dtype
    kernel and its plain version (both tower shapes, the L/14 one and a
    ragged one; bf16 and f32; weights at CLIP-like and 3x larger scales;
    three seeds), and what it reads for two wrong layers computed by the
    plain versions on the card: a dropped bias and, in bf16, fc1 cast before
    quick_gelu. The limits in ops/flash_attention.py were set from these."""
    import dataclasses

    from image_retrieval_tpu_torch.ops import flash_attention as fa

    def gelu_after_cast(x, wt):
        b, t, w = x.shape
        xb = x.reshape(b * t, w)
        h = fa.fast_layernorm_f32(xb.float(), wt.ln_s, wt.ln_b).to(x.dtype)
        a = fa.quick_gelu(fa._dense_proj(h, wt.w1_t, wt.b1).to(x.dtype)).to(x.dtype)
        return (xb + fa._dense_proj(a, wt.w2_t, wt.b2).to(x.dtype)).reshape(b, t, w)

    keys = ("max_abs_err", "max_abs_limit", "diff_share", "min_update_cos")
    worst = {}
    shapes = {"b32-vision": B32_VISION, "b32-text": B32_TEXT, "l14-vision": L14_VISION,
              "ragged": RAGGED}
    for case, (b, t, w, heads, causal) in shapes.items():
        for dt in (torch.bfloat16, torch.float32):
            for scale in (1.0, 3.0):
                for seed in (0, 1, 2):
                    x, wts = dense_layer_inputs(torch, b, t, w, heads, seed, dt, scale)
                    for name, (kernel, plain, kind) in dense_runs(fa).items():
                        want = plain(x, wts, heads, causal)
                        r = fa.dense_agreement(kernel(x, wts, heads, causal), want, x, kind)
                        print(f"reading {name} {case} {str(dt)[6:]} scale {scale} seed {seed}: "
                              + ", ".join(f"{k} {r[k]:.6g}" for k in keys) + f" ok {r['ok']}",
                              flush=True)
                        w_ = worst.setdefault((name, str(dt)[6:]), dict(r))
                        w_["diff_share"] = max(w_["diff_share"], r["diff_share"])
                        w_["rel_limit"] = max(w_.get("rel_limit", 0.0),
                                              r["max_abs_err"] / r["max_abs_limit"])
                        w_["min_update_cos"] = min(w_["min_update_cos"], r["min_update_cos"])
                    want = fa.layer_block_reference(x, wts, heads, causal)
                    for bias in ("bqkv", "bo", "b1", "b2"):
                        bad = dataclasses.replace(wts, **{bias: torch.zeros_like(getattr(wts, bias))})
                        r = fa.dense_agreement(fa.layer_block_reference(x, bad, heads, causal),
                                               want, x, "layer")
                        print(f"wrong layer_block without {bias} {case} {str(dt)[6:]} scale {scale} "
                              f"seed {seed}: " + ", ".join(f"{k} {r[k]:.6g}" for k in keys)
                              + f" ok {r['ok']}", flush=True)
                    if dt == torch.bfloat16:
                        x1 = fa.attention_block_reference(x, wts.attn, heads, causal)
                        for what, base, kind in (("mlp_block", x1, "mlp"),
                                                 ("layer_block", x, "layer")):
                            r = fa.dense_agreement(gelu_after_cast(x1, wts.mlp), want, base, kind)
                            print(f"wrong {what} with the gelu after the cast {case} bfloat16 "
                                  f"scale {scale} seed {seed}: "
                                  + ", ".join(f"{k} {r[k]:.6g}" for k in keys) + f" ok {r['ok']}",
                                  flush=True)
    for (name, dt), w_ in worst.items():
        print(f"worst {name} {dt}: max_abs_err/limit {w_['rel_limit']:.4g}, diff_share "
              f"{w_['diff_share']:.4g}, min_update_cos "
              f"{w_['min_update_cos']:.8f}", flush=True)


def kernel_runs(fa):
    """name -> (kernel, plain version, which part of a layer) with one
    calling convention: (x, whole-layer weights, heads, causal)."""
    return {
        "layer_block_int8": (
            lambda x, w, h, c: fa.layer_block_int8(x, w, h, c),
            lambda x, w, h, c: fa.layer_block_int8_reference(x, w, h, c), "layer"),
        "attention_block_int8": (
            lambda x, w, h, c: fa.attention_block_int8(x, w.attn, h, c),
            lambda x, w, h, c: fa.attention_block_int8_reference(x, w.attn, h, c), "attn"),
        "mlp_block_int8": (
            lambda x, w, h, c: fa.mlp_block_int8(x, w.mlp),
            lambda x, w, h, c: fa.mlp_block_int8_reference(x, w.mlp), "mlp"),
    }


# Shapes (B, T, W, heads, causal) the kernels are timed at, in bf16: B = 8
# (mostly launch overhead) and the batches the main paths of phases 3 and 5
# give them.
B32_VISION, B32_TEXT = (8, 50, 768, 12, False), (8, 77, 512, 8, True)
B16_VISION, L14_VISION = (4, 197, 768, 12, False), (4, 257, 1024, 16, False)
L14_BATCH = (ENC_BUCKET5, 257, 1024, 16, False)
TIME_SHAPES = {
    "layer_block_int8": {"b32-vision-B8": B32_VISION, "b32-text-B8": B32_TEXT,
                         "b32-vision-B256": (256, 50, 768, 12, False),
                         "b32-text-B64": (64, 77, 512, 8, True),
                         "l14-text-B64": (64, 77, 768, 12, True)},
    "attention_block_int8": {"l14-vision-B4": L14_VISION,
                             f"l14-vision-B{ENC_BUCKET5}": L14_BATCH},
    "mlp_block_int8": {"l14-vision-B4": L14_VISION, f"l14-vision-B{ENC_BUCKET5}": L14_BATCH,
                       "b32-vision-B8": B32_VISION,
                       "b32-vision-B256": (256, 50, 768, 12, False)},
}


def time_kernels(torch, card, runs, shapes, int8=True, device=False):
    """{name: {case: {"kernel", "plain", "bound_ms", "bound_by"}}} for the
    layer kernels `runs` (kernel_runs or dense_runs) at `shapes`, in bf16,
    kernel beside plain version beside the bound; with `device`, also the
    device time alone ("device_ms", torch.profiler)."""
    out = {}
    for name, (kernel, plain, kind) in runs.items():
        out[name] = {}
        for case, (b, t, w, heads, causal) in shapes[name].items():
            if int8:
                x32, wts = layer_inputs(torch, b, t, w, heads, seed=len(case))
                xb = x32.to(device="cuda", dtype=torch.bfloat16)
            else:
                xb, wts = dense_layer_inputs(torch, b, t, w, heads, len(case), torch.bfloat16)
            big = b * t > 4096
            r = time_pair(torch, {"kernel": lambda: kernel(xb, wts, heads, causal),
                                  "plain": lambda: plain(xb, wts, heads, causal)},
                          samples=8 if big else 24, reps=2 if big else 5)
            part = {"attn": getattr(wts, "attn", None), "mlp": getattr(wts, "mlp", None),
                    "layer": wts}[kind]
            r.update(block_bound(kind, xb, part, heads, causal, int8))
            if device:
                r["device_ms"] = device_ms(torch, lambda: kernel(xb, wts, heads, causal))
            out[name][case] = r
            dev = f" (device {r['device_ms']} ms)" if device else ""
            print(f"time {name} {case} bf16 B={b} T={t} W={w}: kernel {r['kernel']:.4f} ms{dev}, "
                  f"plain {r['plain']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}) [{card}]", flush=True)
            del xb, wts
            torch.cuda.empty_cache()
    return out


def phase_kernels(torch, card):
    """K1, K2a, K2b and QuantDense against their plain versions, then their
    times beside the plain versions' and the bound. Returns, per kernel,
    {"max_abs_err", "times": {case: {"kernel", "plain", "bound_ms",
    "bound_by"}}}."""
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    runs = kernel_runs(fa)
    halves = {"l14-vision": L14_VISION, "b32-vision": B32_VISION, "b32-text": B32_TEXT}
    agree_shapes = {
        "layer_block_int8": {"b32-vision": B32_VISION, "b32-text": B32_TEXT,
                             "b16-vision": B16_VISION},
        "attention_block_int8": halves,
        "mlp_block_int8": halves,
    }
    out = {name: {"max_abs_err": 0.0, "times": {}} for name in runs}
    for name, shapes in agree_shapes.items():
        kernel, plain, _ = runs[name]
        for case, (b, t, w, heads, causal) in shapes.items():
            x32, wts = layer_inputs(torch, b, t, w, heads, seed=len(case) + w)
            for dt in (torch.bfloat16, torch.float32):
                x = x32.to(device="cuda", dtype=dt)
                err = _agree(fa, torch, name, case, kernel(x, wts, heads, causal),
                             plain(x, wts, heads, causal), x)
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)

    # K2a then K2b run K1's launches on K1's values: equal bit for bit
    x32, wts = layer_inputs(torch, *B32_VISION[:4], seed=21)
    for dt in (torch.bfloat16, torch.float32):
        x = x32.to(device="cuda", dtype=dt)
        two = fa.mlp_block_int8(fa.attention_block_int8(x, wts.attn, 12), wts.mlp)
        one = fa.layer_block_int8(x, wts, 12)
        torch.cuda.synchronize()
        if not torch.equal(two, one):
            fail(f"attention_block_int8 then mlp_block_int8 differs from layer_block_int8 ({dt})")
    print("K2a then K2b equals K1 bit for bit at (8, 50, 768), bf16 and f32", flush=True)
    check_fused_stage(torch, card)

    # QuantDense: the int32 sums are exact and the rowquant and the rescale
    # run the same f32 operations in the same order on both sides: equal
    x32, wts = layer_inputs(torch, *L14_VISION[:4], seed=22)
    for in_dt, out_dt, (w_t, w_s, bias) in (
            (torch.float32, torch.bfloat16, (wts.wqkv_t, wts.wqkv_s, wts.bqkv)),
            (torch.bfloat16, torch.bfloat16, (wts.wo_t, wts.wo_s, wts.bo)),
            (torch.float32, torch.float32, (wts.w1_t, wts.w1_s, wts.b1))):
        x = x32.to(device="cuda", dtype=in_dt)
        got = fa.quant_dense(x, w_t, w_s, bias, out_dt)
        want = fa.quant_dense_reference(x, w_t, w_s, bias, out_dt)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        print(f"quant_dense {tuple(x.shape)} {str(in_dt)[6:]} -> {w_t.shape[0]} "
              f"{str(out_dt)[6:]}: max_abs_err vs plain {err:.3g} (limit 0)", flush=True)
        if not (torch.isfinite(got).all() and err == 0.0):
            fail("quant_dense disagrees with its plain version")

    for name, times in time_kernels(torch, card, runs, TIME_SHAPES).items():
        out[name]["times"] = times
    launch_breakdown(torch, card)
    return out


B32_BATCH, B32_TEXT_BATCH = (256, 50, 768, 12, False), (64, 77, 512, 8, True)
DENSE_TIME_SHAPES = {
    "layer_block": {"b32-vision-B8": B32_VISION, "b32-text-B8": B32_TEXT,
                    "b32-vision-B256": B32_BATCH, "b32-text-B64": B32_TEXT_BATCH,
                    "l14-text-B64": (64, 77, 768, 12, True)},
    "attention_block": {"l14-vision-B4": L14_VISION, f"l14-vision-B{ENC_BUCKET5}": L14_BATCH,
                        "b32-vision-B8": B32_VISION, "b32-vision-B256": B32_BATCH},
    "mlp_block": {"l14-vision-B4": L14_VISION, f"l14-vision-B{ENC_BUCKET5}": L14_BATCH,
                  "b32-vision-B8": B32_VISION, "b32-vision-B256": B32_BATCH,
                  f"b32-vision-B{N_PAIRS}": (N_PAIRS, 50, 768, 12, False)},
}
# K10 at the image batches of phases 3, 7 and 5 (multihead_attention has no
# mask) and, through the packed entry, the causal attention step of a text
# batch.
MHA_TIME_SHAPES = {"b32-vision-B8": B32_VISION, "b32-vision-B256": B32_BATCH,
                   f"l14-vision-B{ENC_BUCKET5}": L14_BATCH, "b32-text-B64": B32_TEXT_BATCH}


def _dense_agree(fa, torch, name, case, got, want, x, kind):
    """dense_agreement of one case, printed; fails the run if it is not ok."""
    torch.cuda.synchronize()
    r = fa.dense_agreement(got, want, x, kind)
    share = (f"{r['diff_share']:.4%} of outputs differ (limit "
             f"{fa.DENSE_BF16_DIFF_SHARE[kind]:.0%}), " if x.dtype == torch.bfloat16 else "")
    print(f"kernel-vs-plain {name} {case} {str(x.dtype)[6:]}: max_abs_err "
          f"{r['max_abs_err']:.6g} (limit {r['max_abs_limit']:.6g}), {share}min per-token cos "
          f"of the update {r['min_update_cos']:.8f} (limit {fa.DENSE_MIN_UPDATE_COS})",
          flush=True)
    if not r["ok"]:
        fail(f"{name} {case} {x.dtype} disagrees with its plain version")
    return r["max_abs_err"]


def mha_inputs(torch, b, t, w, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, t, w), generator=g, device="cuda").to(dtype) for _ in range(3)]


def phase_dense_kernels(torch, card):
    """K8, K9a, K9b and K10 against their plain versions in bf16 and f32, K9a
    then K9b against K8, then their times beside the plain versions' and the
    bounds; for K10 also the time of one scaled_dot_product_attention call
    on the same q, k, v (the same function: its library_ms; the port never
    calls it). Returns, per kernel, {"max_abs_err", "times"}."""
    import torch.nn.functional as F

    from image_retrieval_tpu_torch.ops import flash_attention as fa

    runs = dense_runs(fa)
    shapes = {"b32-vision": B32_VISION, "b32-text": B32_TEXT, "b16-vision": B16_VISION,
              "l14-vision": L14_VISION, "ragged": RAGGED}
    out = {name: {"max_abs_err": 0.0, "times": {}} for name in (*runs, "multihead_attention")}
    for case, (b, t, w, heads, causal) in shapes.items():
        for dt in (torch.bfloat16, torch.float32):
            x, wts = dense_layer_inputs(torch, b, t, w, heads, len(case) + w, dt)
            for name, (kernel, plain, kind) in runs.items():
                err = _dense_agree(fa, torch, name, case, kernel(x, wts, heads, causal),
                                   plain(x, wts, heads, causal), x, kind)
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            # K10: the same order of operations per row on both sides; they
            # differ by the f32 sum order of the dots, and in bf16 by a
            # probability or an output rounding to its neighbour
            q, k, v = mha_inputs(torch, b, t, w, len(case), dt)
            got = fa.multihead_attention(q, k, v, heads)
            want = fa.multihead_attention_reference(q, k, v, heads)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            limit = (2 * float(want.float().abs().max()) * 2.0 ** -8
                     if dt == torch.bfloat16 else 1e-5)
            print(f"kernel-vs-plain multihead_attention {case} {str(dt)[6:]}: max_abs_err "
                  f"{err:.6g} (limit {limit:.6g})", flush=True)
            if not (torch.isfinite(got).all() and err <= limit):
                fail(f"multihead_attention {case} {dt} disagrees with its plain version")
            out["multihead_attention"]["max_abs_err"] = max(
                out["multihead_attention"]["max_abs_err"], err)

    # K9a then K9b run K8's launches on K8's values: equal bit for bit
    for case, (b, t, w, heads, causal) in (("b32-vision", B32_VISION), ("b32-text", B32_TEXT)):
        for dt in (torch.bfloat16, torch.float32):
            x, wts = dense_layer_inputs(torch, b, t, w, heads, 21, dt)
            two = fa.mlp_block(fa.attention_block(x, wts.attn, heads, causal), wts.mlp)
            one = fa.layer_block(x, wts, heads, causal)
            torch.cuda.synchronize()
            if not torch.equal(two, one):
                fail(f"attention_block then mlp_block differs from layer_block ({case}, {dt})")
    print("K9a then K9b equals K8 bit for bit at (8, 50, 768) and (8, 77, 512, causal), "
          "bf16 and f32", flush=True)

    for name, times in time_kernels(torch, card, runs, DENSE_TIME_SHAPES, int8=False).items():
        out[name]["times"] = times
    for case, (b, t, w, heads, causal) in MHA_TIME_SHAPES.items():
        q, k, v = mha_inputs(torch, b, t, w, 5, torch.bfloat16)
        if causal:  # the same device function under the packed entry
            qkv = torch.cat([q, k, v], -1).reshape(b * t, 3 * w)
            kernel = lambda: fa.tiled_attention(qkv, b, heads, causal=True).view(b, t, w)
        else:
            kernel = lambda: fa.multihead_attention(q, k, v, heads)
        plain = lambda: fa.multihead_attention_reference(q, k, v, heads, causal)
        want = plain().float()
        top = float(want.abs().max())
        err = float((kernel().float() - want).abs().max())
        if not err <= 2 * top * 2.0 ** -8:
            fail(f"the attention kernel disagrees with its plain version at {case}: {err:.3g}")
        r = time_pair(torch, {"kernel": kernel, "plain": plain})
        split = lambda a: a.view(b, t, heads, w // heads).transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(split(q), split(k), split(v),
                                                      is_causal=causal)
        # the library call computes the same function (it keeps its
        # probabilities unrounded: a few bf16 steps of the output apart)
        off = float((sdpa().transpose(1, 2).reshape(b, t, w).float() - want).abs().max())
        if not off <= 4 * top * 2.0 ** -8:
            fail(f"scaled_dot_product_attention is {off:.3g} from multihead_attention's plain "
                 f"version at {case}: not the same function")
        lib = time_pair(torch, {"kernel": sdpa, "plain": lambda: None}, samples=12)["kernel"]
        # QK^T and PV: 4 hd per query-key pair visited and head; q, k, v
        # read, out written
        pairs = t * (t + 1) // 2 if causal else t * t
        r.update(bound(0.0, 4.0 * b * pairs * w, 4 * q.numel() * q.element_size()),
                 library_ms=lib, device_ms=device_ms(torch, kernel),
                 library_device_ms=device_ms(torch, sdpa))
        out["multihead_attention"]["times"][case] = r
        entry = "tiled_attention(causal=True)" if causal else "multihead_attention"
        print(f"time {entry} {case} bf16 B={b} T={t} W={w}: kernel "
              f"{r['kernel']:.4f} ms, plain {r['plain']:.4f} ms, one "
              f"scaled_dot_product_attention{'(is_causal=True)' if causal else ''} call "
              f"{lib:.4f} ms (within {off:.3g} of the plain version; kernel within {err:.3g}), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); kernel / library "
              f"{r['kernel'] / lib:.3f}; device time alone (torch.profiler): kernel "
              f"{r['device_ms']} ms, library {r['library_device_ms']} ms [{card}]", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return out


# fc1 and fc2 of K9b and K2b alone at the main paths' image batches
STAGE_SHAPES = {f"l14-vision-B{ENC_BUCKET5}": L14_BATCH, "b32-vision-B256": B32_BATCH}


def mlp_stage_calls(torch, fa, shape, int8, seed):
    """{stage: (kernel, plain, library, check, bound)} for the q/k/v and
    out-projection GEMMs of the attention half and fc1 and fc2 of the MLP
    half on seeded weights and inputs: the GEMM wrappers with the epilogues
    K9a and K9b (bf16) or K2a and K2b (int8) give them, on the operands their
    chains hand them (the out-projection's on a seeded stand-in of unit scale
    for the attention's output). `library` is one PyTorch call on the same
    operands (torch.nn.functional.linear in bf16, torch._int_mm in int8) as a
    yardstick: it computes the product and not the epilogue, and the port
    never calls it. `check` holds the kernel against its plain version: bit
    for bit in int8, by gemm_bf16_agreement's float64 limit in bf16."""
    import torch.nn.functional as F

    b, t, w, heads, _ = shape
    m = b * t
    if int8:
        x32, wts = layer_inputs(torch, b, t, w, heads, seed)
        aw, mw = wts.attn, wts.mlp
        x = x32.reshape(m, w).to(device="cuda", dtype=torch.bfloat16)
        hq1, hs1 = fa.rowquant(fa.fast_layernorm_f32(x.float(), aw.ln_s, aw.ln_b))
        g = torch.Generator(device="cuda").manual_seed(seed)
        attn = torch.randn((m, w), generator=g, device="cuda").to(torch.bfloat16)
        aq, as_ = fa.rowquant(attn.float())
        hq, hs = fa.rowquant(fa.fast_layernorm_f32(x.float(), mw.ln_s, mw.ln_b))
        args1 = (hq, mw.w1_t, hs.reshape(-1), mw.w1_s, mw.b1, torch.float32, "gelu")
        gq, gs = fa.rowquant(fa.gemm_s8(*args1))
        args2 = (gq, mw.w2_t, gs.reshape(-1), mw.w2_s, mw.b2, torch.bfloat16, "residual", x)
        hidden = mw.w1_t.shape[0]
        args_rq = (*args1[:5], torch.int8, fa.GELU_ROWQUANT)
        # fc1 -> quick_gelu -> rowquant: int8 rows and one f32 scale a row out
        calls = {"qkv": ((hq1, aw.wqkv_t, hs1.reshape(-1), aw.wqkv_s, aw.bqkv, torch.bfloat16,
                          "bias"), lambda: torch._int_mm(hq1, aw.wqkv_t.t()), m * 3 * w * 2),
                 "out": ((aq, aw.wo_t, as_.reshape(-1), aw.wo_s, aw.bo, torch.bfloat16,
                          "residual", x), lambda: torch._int_mm(aq, aw.wo_t.t()), m * w * 2),
                 "fc1": (args1, lambda: torch._int_mm(hq, mw.w1_t.t()), m * hidden * 4),
                 "fc1_rowquant": (args_rq, lambda: torch._int_mm(hq, mw.w1_t.t()),
                                  m * hidden + 4 * m),
                 "fc2": (args2, lambda: torch._int_mm(gq, mw.w2_t.t()), m * w * 2)}

        def bitwise(args):
            got, want = fa.gemm_s8(*args), fa.gemm_s8_reference(*args)
            if isinstance(got, tuple):  # (int8 rows, scales)
                return {"max_abs_err": max(float((g.double() - v.double()).abs().max())
                                           for g, v in zip(got, want)),
                        "ok": all(bool(torch.equal(g, v)) for g, v in zip(got, want))}
            return {"max_abs_err": float((got.double() - want.double()).abs().max()),
                    "ok": bool(torch.equal(got, want))}

        out = {}
        for stage, (args, lib, out_bytes) in calls.items():
            a, bt = args[0], args[1]
            n, k = bt.shape
            # operands, row and column scales, bias, output and (out, fc2) residual
            nbytes = (a.numel() + bt.numel() + 4 * m + 8 * n + out_bytes
                      + (2 * m * n if stage in ("out", "fc2") else 0))
            out[stage] = (lambda args=args: fa.gemm_s8(*args),
                          lambda args=args: fa.gemm_s8_reference(*args), lib,
                          lambda args=args: bitwise(args), bound(2.0 * m * n * k, 0.0, nbytes))
        # the two launches the fused stage replaces: fc1 writing f32, then the
        # rowquant pass over those rows
        out["fc1_rowquant"] += (lambda: fa.ln_rowquant(fa.gemm_s8(*args1)),)
        return out
    x, wts = dense_layer_inputs(torch, b, t, w, heads, seed, torch.bfloat16)
    aw, mw, x = wts.attn, wts.mlp, x.reshape(m, w)
    h1 = fa.fast_layernorm_f32(x.float(), aw.ln_s, aw.ln_b).to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(seed)
    attn = torch.randn((m, w), generator=g, device="cuda").to(torch.bfloat16)
    h = fa.fast_layernorm_f32(x.float(), mw.ln_s, mw.ln_b).to(torch.bfloat16)
    args1 = (h, mw.w1_t, mw.b1, "gelu")
    a1 = fa.gemm_bf16(*args1)
    args2 = (a1, mw.w2_t, mw.b2, "residual", x)
    out = {}
    for stage, args in (("qkv", (h1, aw.wqkv_t, aw.bqkv, "bias")),
                        ("out", (attn, aw.wo_t, aw.bo, "residual", x)),
                        ("fc1", args1), ("fc2", args2)):
        a, bt, bias = args[:3]
        n, k = bt.shape
        residual = args[3] == "residual"
        nbytes = 2 * (a.numel() + bt.numel() + m * n * (2 if residual else 1)) + 4 * n
        check = lambda args=args: fa.gemm_bf16_agreement(fa.gemm_bf16(*args), *args)
        out[stage] = (lambda args=args: fa.gemm_bf16(*args),
                      lambda args=args: fa.gemm_bf16_reference(*args),
                      lambda a=a, bt=bt, bb=bias.to(torch.bfloat16): F.linear(a, bt, bb),
                      check, bound(0.0, 2.0 * m * n * k, nbytes))
    return out


def print_rowquant_plan(fa, lib, case, m, n, k, card):
    """The fused fc1 stage's plan for (m, n, k) and how many of its clusters
    the card holds at once (cudaOccupancyMaxActiveClusters); fails where the
    plan does not fuse a main-path shape or no cluster fits."""
    plan = fa.rowquant_gemm_plan(m, n, k)
    clusters = lib.irt_rowquant_gemm_max_clusters(m, n, k)
    print(f"fc1 -> quick_gelu -> rowquant plan {case} (m {m}, n {n}, k {k}): route "
          f"{plan.route} ({plan.why}); blocks of {plan.rows} x {plan.cols}, {plan.stages} "
          f"stages, {plan.smem_bytes} bytes of shared memory, {plan.threads} threads, grid "
          f"{plan.grid}; clusters the card holds at once: {clusters} "
          f"({clusters * plan.cluster} of its SMs) [{card}]", flush=True)
    if plan.route != "fused" or clusters < 1:
        fail(f"the fused fc1 stage does not run at {case}: {plan.why}, {clusters} clusters")


# fc1 of every tower of the main paths at its batch: (m, hidden, width)
FUSED_STAGE_SHAPES = {"b32-text-B64": (64 * 77, 2048, 512), "b32-vision-B256": (12800, 3072, 768),
                      "l14-text-B64": (64 * 77, 3072, 768),
                      f"l14-vision-B{ENC_BUCKET5}": (ENC_BUCKET5 * 257, 4096, 1024)}


def check_fused_stage(torch, card):
    """fc1 -> quick_gelu -> rowquant as one clustered launch against its plain
    version, bit for bit (int8 rows and scales), at every hidden width of
    the main paths; seeded int8 operands with scales of rowquant's size."""
    from image_retrieval_tpu_torch.ops import flash_attention as fa
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    for case, (m, n, k) in FUSED_STAGE_SHAPES.items():
        print_rowquant_plan(fa, lib, case, m, n, k, card)
        g = torch.Generator(device="cuda").manual_seed(m + n)
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        rs = 0.02 * torch.rand(m, generator=g, device="cuda") + 1e-3
        cs = (0.02 * torch.rand(n, generator=g, device="cuda") + 1e-3) / k ** 0.5
        bias = 0.02 * torch.randn(n, generator=g, device="cuda")
        got = fa.gemm_s8(a, bt, rs, cs, bias, torch.int8, fa.GELU_ROWQUANT)
        want = fa.gemm_s8_reference(a, bt, rs, cs, bias, torch.int8, fa.GELU_ROWQUANT)
        torch.cuda.synchronize()
        ok = all(torch.equal(x, y) for x, y in zip(got, want))
        print(f"kernel-vs-plain fc1 -> quick_gelu -> rowquant {case} (m {m}, n {n}, k {k}): "
              f"int8 rows and scales {'equal bit for bit' if ok else 'DIFFER'}", flush=True)
        if not ok:
            fail(f"the fused fc1 stage differs from its plain version at {case}")
        del a, bt, got, want
        torch.cuda.empty_cache()


def ptxas_report(lib_path, pattern):
    """{kernel: ptxas's registers and spill line} from build.log for the
    kernels whose mangled name holds `pattern`."""
    import re

    found, name = {}, None
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                name = m.group(1)
                continue
            if name and pattern in name and ("registers" in line or "spill" in line):
                found[name] = (found.get(name, "") + " " + line.strip()).strip()
    return found


def print_new_kernel_registers(lib_path):
    """Registers and spills of the GEMM (every bf16 and int8 form the library
    builds), the LayerNorm pass of the compute-type chains, the fused fc1
    stage and the int8 row pass; fails on a spill."""
    import re

    for pattern in ("gemm_persistent_kernel", "ln_cast_kernel", "gemm_wgmma_s8_rowquant_kernel",
                    "ln_rowquant_kernel"):
        found = ptxas_report(lib_path, pattern)
        if not found:
            fail(f"build.log holds no {pattern} instantiation")
        for name, line in sorted(found.items()):
            print(f"ptxas {pattern} {name[-60:]}: {line}", flush=True)
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            if any(spills):
                fail(f"{name} spills: {line}")


def run_experiment(card, name, label):
    """Build csrc/experiments/<name>.cu (a standalone program, not part of
    the library) with the library's nvcc flags, print ptxas's registers and
    spills, run it and print its lines; fails when it fails or prints "NO"
    (a variant that differs from the library's kernel)."""
    from image_retrieval_tpu_torch.ops import _build

    src = os.path.join(_build.CSRC, "experiments", f"{name}.cu")
    out_dir = os.path.join(_build.BUILD_ROOT, "experiments")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, name)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    cc = subprocess.run([_build.find_nvcc(), *flags, src, "-o", exe], capture_output=True,
                        text=True)
    for line in (cc.stdout + cc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"{label} ptxas: {line.strip()}", flush=True)
    if cc.returncode != 0:
        fail(f"nvcc failed on {src}:\n{cc.stdout[-4000:]}{cc.stderr[-4000:]}")
    run = subprocess.run([exe], capture_output=True, text=True, timeout=600)
    for line in run.stdout.splitlines():
        print(f"{label}: {line} [{card}]", flush=True)
    if run.returncode != 0 or "NO" in run.stdout.split():
        fail(f"the {label} failed or differ from the library's kernel: {run.stderr}")


def phase_time_dense(torch, card):
    """--time-dense: the compute-type chains' times alone, in bf16, each
    beside its plain version, its bound and its device time (torch.profiler;
    at B = 8 the event time beside it shows the host side of a call): K8 at
    its five shapes, K9a at its four, K11 at the trainer's two (in turns with
    K9a); the device time of each launch kind of K8 at B/32 vision B = 256
    and of K9a at the L/14 image batch; and the four bf16 GEMM stages (q/k/v,
    out-projection, fc1, fc2) at the L/14 and B/32 image batches beside
    F.linear. Uses only entries that earlier checkouts also have, so that a
    copy of this script in a parent checkout times the parent the same way."""
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    runs = dense_runs(fa)
    time_kernels(torch, card, {k: runs[k] for k in ("layer_block", "attention_block")},
                 DENSE_TIME_SHAPES, int8=False, device=True)
    time_train_kernel(torch, card, device=True)
    launch_breakdown(torch, card, dense=True)
    phase_gemm_stages(torch, card, halves=("mlp_block",))


def launch_breakdown(torch, card, dense=False):
    """Device time of each launch kind, bf16, torch.profiler over ten calls
    after three warm ones: of K1 at B/32 vision B = 256 and of the L/14 int8
    image batch's layer (K2a then K2b at B = 128), or with `dense` of K8 at
    B/32 vision B = 256 and of K9a at the L/14 image batch. Uses only entries
    that earlier checkouts also have, so that --time-k1 and --time-dense read
    both."""
    from torch.profiler import ProfilerActivity, profile

    from image_retrieval_tpu_torch.ops import flash_attention as fa

    cases = {"K1 b32-vision-B256": (B32_BATCH, lambda x, w: fa.layer_block_int8(x, w, 12)),
             f"K2a+K2b l14-vision-B{ENC_BUCKET5}": (
                 L14_BATCH, lambda x, w: fa.mlp_block_int8(
                     fa.attention_block_int8(x, w.attn, 16), w.mlp))}
    if dense:
        cases = {"K8 b32-vision-B256": (B32_BATCH, lambda x, w: fa.layer_block(x, w, 12)),
                 f"K9a l14-vision-B{ENC_BUCKET5}": (
                     L14_BATCH, lambda x, w: fa.attention_block(x, w.attn, 16))}
    calls = 10
    for case, ((b, t, w, heads, _), call) in cases.items():
        if dense:
            x, wts = dense_layer_inputs(torch, b, t, w, heads, 3, torch.bfloat16)
        else:
            x32, wts = layer_inputs(torch, b, t, w, heads, seed=3)
            x = x32.to(device="cuda", dtype=torch.bfloat16)
        for _ in range(3):
            call(x, wts)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call(x, wts)
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
                for e in prof.key_averages() if e.device_type.name == "CUDA"]
        total = sum(r[1] for r in rows)
        if total <= 0:
            print(f"launch breakdown {case}: torch.profiler recorded no device time; not "
                  f"measured", flush=True)
            continue
        for key, ms, n in sorted(rows, key=lambda r: -r[1]):
            print(f"launch breakdown {case} bf16: {n:g} launch(es) a call of {key[:110]}: "
                  f"device {ms:.4f} ms a call ({ms / total:.1%}) [{card}]", flush=True)
        print(f"launch breakdown {case} bf16: {sum(r[2] for r in rows):g} launches a call, "
              f"device {total:.4f} ms a call [{card}]", flush=True)
        del x, wts
        torch.cuda.empty_cache()


def phase_gemm_stages(torch, card, halves=("mlp_block", "mlp_block_int8"), only=None):
    """The GEMM stages alone (the GEMMs of csrc/gemm_sm90.cuh with their
    chains' epilogues) at the L/14 and B/32 image batches: q/k/v and the
    out-projection of K9a and K2a, fc1 and fc2 of K9b and K2b (bf16 with
    "mlp_block" in `halves`, int8 with "mlp_block_int8"), or only the stages
    named in `only`: each against its plain version, then its time beside
    the plain version's, one library call's on the same operands, the device
    time alone and the bound. Returns {"attention_block" | "mlp_block" |
    "attention_block_int8" | "mlp_block_int8": {case: {stage: readings}}}."""
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    from image_retrieval_tpu_torch.ops._build import load_library

    out = {"attention_block": {}, "mlp_block": {}, "attention_block_int8": {},
           "mlp_block_int8": {}}
    for name in halves:
        int8 = name == "mlp_block_int8"
        for case, shape in STAGE_SHAPES.items():
            out[name][case] = {}
            if int8 and (only is None or "fc1_rowquant" in only):
                b, t, w = shape[:3]
                print_rowquant_plan(fa, load_library(), case, b * t, 4 * w, w, card)
            for stage, (kernel, plain, lib, check, bnd, *pair) in mlp_stage_calls(
                    torch, fa, shape, int8, seed=len(case)).items():
                if only is not None and stage not in only:
                    continue
                half = (("attention_block_int8" if int8 else "attention_block")
                        if stage in ("qkv", "out") else name)
                agree = check()
                torch.cuda.synchronize()
                limit = "bit for bit" if int8 else (
                    f"{agree['max_share_of_limit']:.4f} of the float64 limit")
                print(f"kernel-vs-plain {half} {stage} {case}: max_abs_err "
                      f"{agree['max_abs_err']:.6g} ({limit})", flush=True)
                if not agree["ok"]:
                    fail(f"the GEMM of {half} {stage} {case} disagrees with its plain version")
                r = time_pair(torch, {"kernel": kernel, "plain": plain}, samples=8, reps=3)
                r["library_ms"] = time_pair(torch, {"kernel": lib, "plain": lambda: None},
                                            samples=8, reps=3)["kernel"]
                r.update(bnd, device_ms=device_ms(torch, kernel),
                         library_device_ms=device_ms(torch, lib))
                if pair:  # the fused stage in turns with the two launches it replaces
                    two = time_pair(torch, {"kernel": kernel, "plain": pair[0]}, samples=8,
                                    reps=3)
                    r.update(pair_ms=two["plain"], in_turns_ms=two["kernel"],
                             pair_device_ms=device_ms(torch, pair[0]))
                    print(f"time {name} {stage} {case}: the fused stage {two['kernel']:.4f} "
                          f"ms in turns with the two launches it replaces (fc1 writing f32, "
                          f"then rowquant) {two['plain']:.4f} ms (device "
                          f"{r['pair_device_ms']} ms) [{card}]", flush=True)
                out[half].setdefault(case, {})[stage] = r
                print(f"time {half} {stage} {case}: kernel {r['kernel']:.4f} ms (device "
                      f"{r['device_ms']} ms), plain {r['plain']:.4f} ms, library "
                      f"{'F.linear' if not int8 else 'torch._int_mm'} {r['library_ms']:.4f} ms "
                      f"(device {r['library_device_ms']} ms), bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}); kernel at {r['bound_ms'] / r['kernel']:.1%} of its "
                      f"bound [{card}]", flush=True)
            torch.cuda.empty_cache()
    return out


TRAIN_TIME_SHAPES = {f"b32-vision-B{N_PAIRS}": (N_PAIRS, 50, 768, 12, False),
                     f"b32-text-B{N_PAIRS}": (N_PAIRS, 77, 512, 8, True)}


def saved_bound(x, wts, heads, causal) -> dict:
    """Bound of one attention_block_train forward: attention_block's
    operations (block_bound) and its bytes plus the extra outputs, q, k, v
    and attn in the compute dtype and the (B, H, T, T) f32 probabilities."""
    b, t, w = x.shape
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 8.0 * w * w * b * t + 4.0 * b * pairs * w
    nbytes = (6 * x.numel() * x.element_size() + 4 * b * heads * t * t
              + sum(a.numel() * a.element_size() for a in wts.tensors()))
    return bound(0.0, flops, nbytes)


def phase_train_kernel(torch, card):
    """K11, the forward that saves for its backward, against its plain
    version in bf16 and f32, at B = 8, at the trainer's batch and at a ragged
    shape; its output against K9a's, bit for bit; then its times at the
    trainer's batch beside K9a's, the plain version's and the bound. Returns
    {"attention_block_train": {"max_abs_err", "times"}}."""
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    name = "attention_block_train"
    out = {"max_abs_err": 0.0, "times": {}}
    shapes = {"b32-vision-B8": B32_VISION, "b32-text-B8": B32_TEXT, "ragged": RAGGED,
              **TRAIN_TIME_SHAPES}  # the last two: what the trainer's steps give it
    for case, (b, t, w, heads, causal) in shapes.items():
        for dt in (torch.bfloat16, torch.float32):
            x, wts = dense_layer_inputs(torch, b, t, w, heads, len(case) + w, dt)
            got = fa.attention_block_saved(x, wts.attn, heads, causal)
            want = fa.attention_block_saved_reference(x, wts.attn, heads, causal)
            for part, g, wn in zip(("o", "q", "k", "v", "attn"), got, want):
                # q, k, v and attn are no residual updates: judged as outputs
                # of the attention half on a zero input
                ref_x = x if part == "o" else torch.zeros_like(x)
                err = _dense_agree(fa, torch, f"{name}.{part}", case, g.contiguous(),
                                   wn.contiguous(), ref_x, "attn")
                out["max_abs_err"] = max(out["max_abs_err"], err)
            probs, pwant = got[5], want[5]
            perr = float((probs - pwant).abs().max())
            rows = float((probs.sum(-1) - 1).abs().max())
            above = torch.triu(torch.ones(t, t, dtype=torch.bool, device="cuda"), diagonal=1)
            upper = float(probs[..., above].abs().max()) if causal else 0.0
            same = torch.equal(got[0], fa.attention_block(x, wts.attn, heads, causal))
            limit = PROBS_ATOL[str(dt)[6:]]
            print(f"kernel-vs-plain {name}.probs {case} {str(dt)[6:]}: {tuple(probs.shape)} f32, "
                  f"max_abs_err {perr:.3g} (limit {limit}), rows sum to 1 within {rows:.3g}, "
                  f"largest entry above a causal diagonal {upper} (limit 0); output equals "
                  f"attention_block's bit for bit: {same}", flush=True)
            if not (probs.dtype == torch.float32 and perr <= limit and rows <= 1e-5
                    and upper == 0.0 and same):
                fail(f"{name} {case} {dt}: probabilities or output disagree")
            del x, wts, got, want, probs, pwant
        torch.cuda.empty_cache()

    out["times"] = time_train_kernel(torch, card)
    return {name: out}


def time_train_kernel(torch, card, device=False):
    """K11's times at the trainer's batch beside K9a's (in turns), the plain
    version's and the bound; with `device`, also the device time alone
    (torch.profiler). Returns {case: readings}."""
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    out = {}
    for case, (b, t, w, heads, causal) in TRAIN_TIME_SHAPES.items():
        x, wts = dense_layer_inputs(torch, b, t, w, heads, len(case), torch.bfloat16)
        a = wts.attn
        r = time_pair(torch, {
            "kernel": lambda: fa.attention_block_saved(x, a, heads, causal),
            "plain": lambda: fa.attention_block_saved_reference(x, a, heads, causal)},
            samples=8, reps=2)
        # K9a beside it, in turns with K11 ("plain" is K9a here)
        k9a = time_pair(torch, {
            "kernel": lambda: fa.attention_block_saved(x, a, heads, causal),
            "plain": lambda: fa.attention_block(x, a, heads, causal)}, samples=12, reps=3)
        r.update(saved_bound(x, a, heads, causal), k9a_ms=k9a["plain"],
                 beside_k9a_ms=k9a["kernel"])
        if device:
            r["device_ms"] = device_ms(torch, lambda: fa.attention_block_saved(x, a, heads,
                                                                               causal))
        out[case] = r
        print(f"time attention_block_train {case} bf16 B={b} T={t} W={w}: kernel "
              f"{r['kernel']:.4f} ms (device {r.get('device_ms', 'not measured')} ms), plain "
              f"{r['plain']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); in turns "
              f"with attention_block (K9a): {k9a['kernel']:.4f} vs {k9a['plain']:.4f} ms "
              f"[{card}]", flush=True)
        del x, wts, a
        torch.cuda.empty_cache()
    return out


def time_train_backward(torch, card):
    """The backward of the attention half at the trainer's batch, bf16: the
    hand-written one over what K11 saved beside the one that recomputes the
    forward through the plain version (K9a's autograd Function). Both start
    from a finished forward; samples in turns recompute/saved/saved/recompute.
    Returns {case: {"saved_ms", "recompute_ms"}}."""
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    out = {}
    for case, (b, t, w, heads, causal) in TRAIN_TIME_SHAPES.items():
        rng = np.random.default_rng(len(case))
        params = [p.requires_grad_(True) for p in layer_params(torch, w, rng)]
        x = torch.from_numpy(rng.standard_normal((b, t, w)).astype(np.float32)).to(
            device="cuda", dtype=torch.bfloat16).requires_grad_(True)
        g = torch.from_numpy(rng.standard_normal((b, t, w)).astype(np.float32)).to(
            device="cuda", dtype=torch.bfloat16)
        grads = {}

        def one(fn, key):
            # the weight casts are part of the graph, as in Block.dense_weights
            y = fn(x, fa.prepare_layer(*params, dtype=torch.bfloat16).attn, heads, causal)
            for p in (x, *params):
                p.grad = None
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            y.backward(g)
            e.record()
            e.synchronize()
            grads[key] = [x.grad] + [p.grad for p in params[:10]]
            return s.elapsed_time(e)

        fns = {"saved": fa.attention_block_train, "recompute": fa.attention_block}
        for key, fn in fns.items():
            one(fn, key)
        ms = {k: [] for k in fns}
        for _ in range(4):
            for key in ("recompute", "saved", "saved", "recompute"):
                ms[key].append(one(fns[key], key))
        cos = min(float(row_cos(a.float().reshape(1, -1), c.float().reshape(1, -1)))
                  for i, (a, c) in enumerate(zip(grads["saved"], grads["recompute"]))
                  if i != 6)  # the key bias: zero in exact arithmetic, noise in both
        out[case] = {f"{k}_ms": float(np.median(v)) for k, v in ms.items()}
        print(f"backward of the attention half {case} bf16 B={b} T={t} W={w}: hand-written over "
              f"the saved tensors {out[case]['saved_ms']:.4f} ms, recompute through the plain "
              f"version {out[case]['recompute_ms']:.4f} ms; gradients' min cosine {cos:.6f} "
              f"(limit {GRAD_MIN_COS}) [{card}]", flush=True)
        if not cos >= GRAD_MIN_COS:
            fail(f"{case}: the hand-written backward left the recomputing one")
        del params, x, g, grads
        torch.cuda.empty_cache()
    return out


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


def serve_wave(server, queries, requests=None):
    """One wave of concurrent clients, one per query, through `server`;
    requests[i] holds client i's further arguments of `search` (metric,
    weights, flt). Returns (answers, seconds, micro-batches)."""
    answers = [None] * len(queries)
    errors = []

    def client(i):
        try:
            answers[i] = server.search(queries[i], top_k=TOP_K, timeout=300,
                                       **(requests[i] if requests else {}))
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


def check_f32_answers(index, q_emb, answers):
    """Served top-10 answers of an f32 index against the float64 oracle for
    the query embeddings `q_emb`: scores within ORACLE_SCORE_ATOL, ranked ids
    identical except where the oracle's neighbours are closer than that."""
    path_id = {p: i for i, p in enumerate(index.paths)}
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
    # magnitudes in [0.5, 4] and a `bucket` attribute for phase 6: the
    # cosine searches of this phase read neither
    index.insert([f"gallery/{i:07d}" for i in range(N_ROWS)], rows,
                 grng.uniform(0.5, 4.0, N_ROWS).astype(np.float32),
                 attrs={"bucket": np.arange(N_ROWS) % 8})
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

    q_emb = enc.encode_texts(queries)
    check_f32_answers(index, q_emb, answers)

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
    return launches, enc, queries, q_emb, index


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


def planted_rows(q_emb, rng, n_rows=N4):
    """PLANTED4 rows per query, normalize(q_hat + sigma * noise) with sigma
    set for cosines spread over 0.3-0.95, at distinct seeded positions
    among `n_rows`."""
    qhat = q_emb / np.linalg.norm(q_emb, axis=1, keepdims=True)
    nq, d = qhat.shape
    rho = rng.uniform(0.3, 0.95, size=(nq, PLANTED4, 1))
    sigma = np.sqrt((1.0 / rho ** 2 - 1.0) / d)
    rows = qhat[:, None, :] + sigma * rng.standard_normal((nq, PLANTED4, d))
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    pos = rng.choice(n_rows, size=nq * PLANTED4, replace=False)
    return pos, rows.reshape(-1, d).astype(np.float32)


def gallery_chunk(torch, c, d, pos, planted, n=CHUNK4, seed=1000):
    """Chunk c (of n rows) of the seeded unit gallery (made on the card),
    with the planted rows that fall inside it."""
    g = torch.Generator(device="cuda").manual_seed(seed + c)
    rows = torch.randn((n, d), generator=g, device="cuda")
    rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    rows = rows.cpu().numpy()
    inside = (pos >= c * n) & (pos < (c + 1) * n)
    rows[pos[inside] - c * n] = planted[inside]
    return rows


def int8_exact_oracle(torch, index, depth):
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


def check_answers(index, oracle):
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


def check_clients_got_the_indexs_answers(name, ix, waves):
    """Every client's answer of every wave is, hit for hit, what a recorded
    "wave" search of `ix` returned."""
    seen = {tuple((ix.paths[i], float(v)) for v, i in zip(vr, ir))
            for stage, _, _, (vals, idx) in ix.calls if stage == "wave"
            for vr, ir in zip(vals, idx)}
    for answers, _, _ in waves:
        for a in answers:
            if a is None or tuple((h["path"], h["score"]) for h in a) not in seen:
                fail(f"{name}: a client's answer is not what the index returned")


def screen_bound(nq, rows, d, i8=False) -> dict:
    """The least time of one screen launch: 2 Q rows D multiply-adds at the
    bf16 (K3) or int8 (K12) peak; bytes: the packed rows, their scales and
    validity, the queries and the f32 score plane, each once."""
    ops = 2.0 * nq * rows * d
    nbytes = rows * (d // 2 + 4 + 1) + nq * d * (1 if i8 else 2) + nq * rows * 4
    return bound(ops if i8 else 0.0, 0.0 if i8 else ops, nbytes)


def device_note(t) -> str:
    """' (device X)' for a timing dict that holds a device time, else ''."""
    if "device_ms" not in t:
        return ""
    ms = t["device_ms"]
    return f" (device {ms if ms is None else round(ms, 4)})"


def screen_vs_plain(torch, card, packed, scales, valid, qu64, counts=(1, 64), device=False):
    """K3 against its plain version on one segment at each Q of `counts`: the
    same -inf pattern, scores within SCREEN_MAX_ABS, the same top-128 sets
    except boundary near-ties; then both timed in turns, beside the bound,
    and with `device` the kernel's device time (torch.profiler). Returns
    {nq: {"kernel", "plain", "max_abs_err", "bound_ms", ...}}."""
    from image_retrieval_tpu_torch.ops import int4_screen as k3
    from image_retrieval_tpu_torch.ops.topk import exact_topk_wide

    seg, d = packed.shape[0], 2 * packed.shape[1]
    out = {}
    for nq in counts:
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
        del got, want, fin
        fns = {"kernel": lambda: k3.int4_screen_scores(qu, packed, scales, valid),
               "plain": lambda: k3.int4_screen_scores_reference(qu, packed, scales, valid)}
        t = dict(time_pair(torch, fns), **screen_bound(nq, seg, d), max_abs_err=err)
        if device:
            t["device_ms"] = device_ms(torch, fns["kernel"])
        dev = device_note(t)
        print(f"int4_screen kernel-vs-plain Q={nq}, {seg} rows x {d}: max_abs_err "
              f"{err:.3g} (limit {k3.SCREEN_MAX_ABS}), top-{RERANK_C} sets identical "
              f"except {swaps} boundary near-ties; kernel {t['kernel']:.4f} ms{dev}, plain "
              f"{t['plain']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
              f"{100 * t['bound_ms'] / t['kernel']:.1f} % of it) [{card}]", flush=True)
        if not err <= k3.SCREEN_MAX_ABS:
            fail(f"int4_screen Q={nq} disagrees with its plain version")
        out[nq] = t
        torch.cuda.empty_cache()
    return out


def screen_i8_vs_plain(torch, card, packed, scales, valid, qu64, counts=(1, 64), device=False):
    """K12, the int8-query screen, on one segment at each Q of `counts`: bit
    for bit against its plain version; its times beside the plain version's,
    in turns with K3's, beside its bound, and with `device` its device time."""
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    seg, d = packed.shape[0], 2 * packed.shape[1]
    out = {}
    for nq in counts:
        qu = qu64[:nq].contiguous()
        q8, _ = k3.quantize_queries_i8(qu)
        got = k3.int4_screen_scores_i8(q8, packed, scales, valid)
        want = k3.int4_screen_scores_i8_reference(q8, packed, scales, valid)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        same = torch.equal(got, want)
        err = float((got[fin] - want[fin]).abs().max())
        del got, want, fin
        fns = {"kernel": lambda: k3.int4_screen_scores_i8(q8, packed, scales, valid),
               "plain": lambda: k3.int4_screen_scores_i8_reference(q8, packed, scales, valid)}
        t = time_pair(torch, fns, samples=8, reps=2)
        beside = time_pair(torch, {  # "plain" is K3 here
            "kernel": fns["kernel"],
            "plain": lambda: k3.int4_screen_scores(qu, packed, scales, valid)})
        t = dict(t, **screen_bound(nq, seg, d, i8=True), max_abs_err=err,
                 k3_ms=beside["plain"], beside_k3_ms=beside["kernel"])
        if device:
            t["device_ms"] = device_ms(torch, fns["kernel"])
        dev = device_note(t)
        print(f"int4_screen i8 kernel-vs-plain Q={nq}, {seg} rows x {d}: equal bit for bit: "
              f"{same} (max_abs_err {err:.3g}, limit 0); kernel {t['kernel']:.4f} ms{dev}, "
              f"plain {t['plain']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
              f"{100 * t['bound_ms'] / t['kernel']:.1f} % of it); in turns with the "
              f"bf16-query kernel (K3): {beside['kernel']:.4f} vs {beside['plain']:.4f} ms "
              f"[{card}]", flush=True)
        if not same:
            fail(f"int4_screen i8 Q={nq} is not its plain version bit for bit")
        out[nq] = t
        torch.cuda.empty_cache()
    return out


def first_segment(torch, index):
    """The first SEGMENT_ROWS rows of an int4 index on the card, 1 % of them
    invalid (seeded)."""
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    seg = k3.SEGMENT_ROWS
    g = torch.Generator(device="cuda").manual_seed(7)
    valid = torch.rand(seg, generator=g, device="cuda") >= 0.01
    return index._packed[:seg], index._scales4[:seg], valid


def kernel_vs_plain_int4(torch, card, index, qu64):
    """K3 against its plain version on the first 2^21-row segment of the
    card's packed rows, 1 % of rows invalid, at Q = 1 and Q = 64."""
    packed, scales, valid = first_segment(torch, index)
    out = screen_vs_plain(torch, card, packed, scales, valid, qu64)
    out["rows"] = packed.shape[0]
    return out


def kernel_vs_plain_int4_i8(torch, card, index, qu64):
    """K12, the int8-query screen, on K3's segment: bit for bit against its
    plain version at Q = 1 and 64, its times beside K3's (in turns). Then,
    counted, one int4_screen_topc(qform="i8") sweep of the whole gallery,
    whose top-128 is held against the bf16 sweep's by recall. Returns
    {1: times, 64: times, "rows", "launches", "top128", "top10"}."""
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    seg = k3.SEGMENT_ROWS
    out = screen_i8_vs_plain(torch, card, *first_segment(torch, index), qu64)
    out["rows"] = seg

    # ---- the ops-level entry over the whole gallery, counted ---------------
    k3.int4_screen_scores_i8.launches = 0
    v8, i8 = k3.int4_screen_topc(qu64, index._packed, index._scales4, index._valid, RERANK_C,
                                 qform="i8")
    torch.cuda.synchronize()
    out["launches"] = k3.int4_screen_scores_i8.launches
    # ---- end of the counted run --------------------------------------------
    vb, ib = k3.int4_screen_topc(qu64, index._packed, index._scales4, index._valid, RERANK_C)
    segments = -(-index._packed.shape[0] // seg)
    i8l, ibl = i8.tolist(), ib.tolist()
    out["top128"] = float(np.mean([len(set(a) & set(b)) / RERANK_C for a, b in zip(i8l, ibl)]))
    out["top10"] = float(np.mean([len(set(a) & set(b[:TOP_K])) / TOP_K
                                  for a, b in zip(i8l, ibl)]))
    top1 = float((v8[:, 0] - vb[:, 0]).abs().max())
    print(f"int4_screen_topc(qform=\"i8\") over {index._packed.shape[0]} rows, Q=64, c={RERANK_C}: "
          f"{out['launches']} kernel launches (expected {segments} segments); its top-{RERANK_C} "
          f"holds {out['top128']:.4f} of the bf16 sweep's top-{RERANK_C} (limit {I8_TOP128_MIN}) "
          f"and {out['top10']:.4f} of its top-{TOP_K} (limit {I8_TOP10_MIN}); best scores "
          f"within {top1:.3g} [{card}]", flush=True)
    if out["launches"] != segments or not bool(torch.isfinite(v8).all()):
        fail("the i8 sweep did not run the int8-query kernel once per segment")
    if out["top128"] < I8_TOP128_MIN or out["top10"] < I8_TOP10_MIN or top1 > 5e-3:
        fail("the i8 sweep's candidates left the bf16 sweep's")
    return out


def event_ms(torch, fn, samples=11, reps=3, warm=2):
    """Median ms per call of fn over `samples` runs of `reps` calls between
    CUDA events, after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(samples):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        got.append(s.elapsed_time(e) / reps)
    return float(np.median(got))


def seeded_int4_segment(torch, rows=1 << 21, d=512, nq=64, seed=13):
    """One segment of an int4 gallery on the card as the index quantizes it
    (unit rows, absmax / 7 grid, values in -7..7, norm-preserving scales),
    1 % of rows invalid, its int8 rows as the int8 tier holds them (absmax /
    127, norm-preserving scales), and nq unit bf16 queries."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    packed = torch.empty((rows, d // 2), dtype=torch.uint8, device="cuda")
    scales = torch.empty(rows, dtype=torch.float32, device="cuda")
    rows8 = torch.empty((rows, d), dtype=torch.int8, device="cuda")
    scales8 = torch.empty(rows, dtype=torch.float32, device="cuda")
    for lo in range(0, rows, 1 << 17):
        x = torch.randn((min(rows, lo + (1 << 17)) - lo, d), generator=gen, device="cuda")
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        amax = x.abs().amax(dim=1, keepdim=True)
        q4 = torch.clamp(torch.round(x / (amax / 7.0)), -7, 7)
        u = (q4 + 8).to(torch.uint8)
        packed[lo:lo + len(x)] = u[:, 0::2] | (u[:, 1::2] << 4)
        scales[lo:lo + len(x)] = 1.0 / torch.linalg.vector_norm(q4, dim=1)
        r8 = torch.clamp(torch.round(x / (amax / 127.0)), -127, 127)
        rows8[lo:lo + len(x)] = r8.to(torch.int8)
        scales8[lo:lo + len(x)] = 1.0 / torch.linalg.vector_norm(r8, dim=1)
    valid = torch.rand(rows, generator=gen, device="cuda") >= 0.01
    q = torch.randn((nq, d), generator=gen, device="cuda")
    qu = (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)).to(torch.bfloat16)
    return packed, scales, valid, rows8, scales8, qu


def int4_breakdown(torch, card, packed, scales, valid, rows8, scales8, qu64, counts=(1, 64)):
    """Where a segment's time goes in the int4 tier, at each Q: the screen
    launch, the selection segmented_topc runs on its plane (wide_candidates
    and resolve_ties, c = RERANK_C), and per search the latency mode's exact
    rerank of the c candidates (their int8 rows gathered on the card, as
    sharded_int4_two_phase_topk does after the screen), each by CUDA events."""
    from image_retrieval_tpu_torch.ops import int4_screen as k3
    from image_retrieval_tpu_torch.ops.topk import (exact_topk, resolve_ties, two_key_topk,
                                                    wide_candidates)

    out = {}
    for nq in counts:
        qu = qu64[:nq].contiguous()
        plane = k3.int4_screen_scores(qu, packed, scales, valid)
        sv, sidx = resolve_ties(plane, *wide_candidates(plane, RERANK_C))

        def rerank():
            cand = rows8[sidx].to(torch.float32)
            ex = torch.bmm(cand, qu.to(torch.float32)[:, :, None])[..., 0] * scales8[sidx]
            ex = torch.where(torch.isfinite(sv), ex, float("-inf"))
            vals, pos = exact_topk(ex, TOP_K)
            return two_key_topk(vals, torch.gather(sidx, 1, pos), TOP_K, True)

        out[nq] = {
            "screen_ms": event_ms(torch, lambda: k3.int4_screen_scores(qu, packed, scales, valid)),
            "select_ms": event_ms(torch, lambda: resolve_ties(
                plane, *wide_candidates(plane, RERANK_C))),
            "rerank_ms": event_ms(torch, rerank)}
        r = out[nq]
        print(f"int4 tier per {packed.shape[0]}-row segment, Q={nq}: screen {r['screen_ms']:.4f} "
              f"ms, wide_candidates + resolve_ties (c={RERANK_C}) {r['select_ms']:.4f} ms; per "
              f"search the exact rerank of the {RERANK_C} candidates {r['rerank_ms']:.4f} ms "
              f"[{card}]", flush=True)
        del plane
        torch.cuda.empty_cache()
    return out


def print_screen_registers(lib_path):
    """Registers and spills of every int4 screen kernel in build.log; fails on
    a spill."""
    import re

    found = ptxas_report(lib_path, "int4_screen")
    if not found:
        fail("build.log holds no int4 screen kernel")
    for name, line in sorted(found.items()):
        print(f"ptxas int4 screen {name[-70:]}: {line}", flush=True)
        if any(int(x) for x in re.findall(r"(\d+) bytes spill", line)):
            fail(f"{name} spills: {line}")


# --k3-variants: the sweep's design against what it was chosen over, each a
# copy of the port's package with csrc/int4_screen_sm90.cuh edited: every
# unit width one block an SM (before 8- and 16-query units took two), the
# 64-query units on mma.sync (before they took wgmma), and the consumers
# skipping the products (the ring, the queries and the epilogue alone: what
# the memory side takes; 64-query units then skip their wgmma as well).
K3_VARIANTS = {
    "one-block-an-SM": (("screen_blocks_per_sm(int qw) { return qw <= 16 ? 2 : 1; }",
                         "screen_blocks_per_sm(int qw) { return 1; }"),),
    "mma.sync-for-64": (("screen_uses_wgmma(bool i8, int qw) { return !i8 && qw == 64; }",
                         "screen_uses_wgmma(bool i8, int qw) { return false; }"),),
    "ring-only": (("screen_box_bf16<kNT>(unit, qbox, p.q_pitch, live_q, g, t, acc);",
                   "acc[0][0][0] += (float)(unit[lane] + qbox[lane]);"),
                  ("screen_box_i8<kNT>(unit, qbox, p.q_pitch, live_q, g, t, acc);",
                   "acc[0][0][0] += (int)(unit[lane] + qbox[lane]);"),
                  ("          screen_box_bf16_wg(unit,",
                   "          acc[0][0][0] += (float)unit[lane];\n"
                   "          if (lane < 0) screen_box_bf16_wg(unit,")),
}


def time_screens(torch, card, label):
    """K3 at Q = 1, 8, 64 and K12 at Q = 1, 64 on the seeded segment, timed
    alone (CUDA events, then device time), with no check: the variants of
    --k3-variants run this in their own copies of the package."""
    from image_retrieval_tpu_torch.ops import _build
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    _build.build()
    _build.load_library()
    packed, scales, valid, _, _, qu = seeded_int4_segment(torch)
    for form, counts in (("bf16", K3_QUERIES), ("i8", (1, 64))):
        for nq in counts:
            q = qu[:nq].contiguous()
            if form == "i8":
                q8, _ = k3.quantize_queries_i8(q)
                fn = lambda: k3.int4_screen_scores_i8(q8, packed, scales, valid)
            else:
                fn = lambda: k3.int4_screen_scores(q, packed, scales, valid)
            ms, dev = event_ms(torch, fn, samples=21, reps=5), device_ms(torch, fn)
            print(f"k3 variant {label}: {form} Q={nq}: {ms:.4f} ms, device "
                  f"{dev if dev is None else round(dev, 4)} ms [{card}]", flush=True)


def k3_variants(card):
    """--k3-variants: build the design and each of K3_VARIANTS in its own
    copy under .smoke_tree/k3_variants/ (listed in .gitignore), all at once,
    then time each in turns with the design (design, variants, design)."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, ".smoke_tree", "k3_variants")
    header = os.path.join("image_retrieval_tpu_torch", "csrc", "int4_screen_sm90.cuh")
    with open(os.path.join(here, header)) as f:
        source = f.read()
    names = ["design", *K3_VARIANTS]
    for name in names:
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(here, "image_retrieval_tpu_torch"),
                        os.path.join(d, "image_retrieval_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(os.path.join(here, "chip_smoke.py"), d)
        text = source
        for old, new in K3_VARIANTS.get(name, ()):
            if old not in text:
                fail(f"k3 variant {name}: {old!r} is not in {header}")
            text = text.replace(old, new)
        with open(os.path.join(d, header), "w") as f:
            f.write(text)
    build = "from image_retrieval_tpu_torch.ops import _build; _build.build()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=os.path.join(root, n),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in names]
    for name, proc in zip(names, procs):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"k3 variant {name} did not build:\n{out[-4000:]}")
    run = ("import torch, chip_smoke as c; torch.backends.cuda.matmul.allow_tf32 = False; "
           "c.time_screens(torch, {card!r}, {name!r})")
    for name in (*names, "design"):
        proc = subprocess.run([sys.executable, "-c", run.format(card=card, name=name)],
                              cwd=os.path.join(root, name), capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            fail(f"k3 variant {name} failed:\n{proc.stderr[-4000:]}")


def phase_time_k3(torch, card, lib_path):
    """--time-k3: the screen kernels' registers and spills; K3 and K12 against
    their plain versions on a seeded 2^21 x 512 segment at Q = 1, 8 and 64,
    their times beside the plain versions' and the bounds, with device time;
    then the segment's breakdown (screen, selection, rerank). It uses only
    entries earlier checkouts have: to compare two, copy this script into
    each and run it there in turns."""
    print_screen_registers(lib_path)
    packed, scales, valid, rows8, scales8, qu = seeded_int4_segment(torch)
    screen_vs_plain(torch, card, packed, scales, valid, qu, K3_QUERIES, device=True)
    screen_i8_vs_plain(torch, card, packed, scales, valid, qu, K3_QUERIES, device=True)
    int4_breakdown(torch, card, packed, scales, valid, rows8, scales8, qu)


def phase_int4(torch, card, enc, queries, q_emb):
    """The int4 capacity tier, counted; then its checks, single-query
    latency, K3 against its plain version, and K12 beside it."""
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
        check_clients_got_the_indexs_answers(name, cap if name == "capacity" else lat, both)
    for a in filtered:
        if len(a) != TOP_K or any(int(h["path"][8:]) % 8 != 3 for h in a):
            fail(f"filtered search returned {a!r:.200}")

    worst = {}
    for name, ix in (("capacity", cap), ("latency", lat)):
        worst[name], recall = check_answers(ix, int8_exact_oracle(torch, ix, 3 * TOP_K))
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
    kernel_i8 = kernel_vs_plain_int4_i8(torch, card, cap, qu64)
    return launches, kernel, kernel_i8


def towers_vs_plain(torch, enc, images, texts):
    """Every block of both towers on the card against its plain version on
    the same card and the same input (kernel_agreement for the int8 routes,
    dense_agreement for the routes in the compute dtype), and the chain of
    plain versions from the first block's input against the chain of
    kernels (per-token cosine of the last block's output). Returns the
    smallest cosine per tower."""
    from image_retrieval_tpu_torch.models.clip import KERNEL, LAYER
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    seen = []
    towers = {"vision": enc.model.vision, "text": enc.model.text}
    hooks = [blk.register_forward_hook(
        lambda blk, args, out, name=name: seen.append((name, blk, args[0], out)))
        for name, tower in towers.items() for blk in tower.blocks]
    try:
        enc.encode_pixels(images)
        enc.encode_texts(texts)
    finally:
        for h in hooks:
            h.remove()

    def plain(blk, x):
        if blk.mode[0] in (LAYER, KERNEL):
            return fa.layer_block_int8_reference(x, blk.int8_weights(), blk.heads, blk.causal)
        return fa.layer_block_reference(x, blk.dense_weights(x.dtype), blk.heads, blk.causal)

    cos = {}
    with torch.inference_mode():
        for name, tower in towers.items():
            blocks = [e for e in seen if e[0] == name]
            if len(blocks) != len(tower.blocks):
                fail(f"{name}: {len(blocks)} block calls for {len(tower.blocks)} blocks")
            chain, worst = blocks[0][2], 0.0
            for i, (_, blk, x, out) in enumerate(blocks):
                want = plain(blk, x)
                r = (fa.kernel_agreement(out, want, x) if blk.mode[0] in (LAYER, KERNEL)
                     else fa.dense_agreement(out, want, x, "layer"))
                if not r["ok"]:
                    fail(f"{name} block {i} on the card disagrees with its plain version: {r}")
                worst = max(worst, r["max_abs_err"])
                chain = plain(blk, chain)
            cos[name] = float(row_cos(blocks[-1][3], chain).min())
            print(f"{name} tower, {len(blocks)} blocks {tuple(blocks[0][2].shape)} "
                  f"{str(chain.dtype)[6:]} routed {blocks[0][1].mode}: every block within the "
                  f"limits of its plain version (max_abs_err {worst:.4g}); plain chain vs "
                  f"kernel chain min per-token cos {cos[name]:.6f} (limit {TOWER_MIN_COS})",
                  flush=True)
            if not cos[name] >= TOWER_MIN_COS:
                fail(f"the {name} tower through the kernels left its plain version")
    return cos


def profile_encode(torch, enc, images, card, label="L/14"):
    """One warm encode_pixels call under torch.profiler: wall time, and the
    device's self time by kernel family (the launches are serial on one
    stream, so their sum is the device's busy time)."""
    from torch.profiler import ProfilerActivity, profile

    families = (("gemm_wgmma_s8_rowquant", "fc1 + quick_gelu + rowquant (clustered GEMM)"),
                ("Int8Epilogue", "int8 GEMMs (wgmma)"),
                ("DenseEpilogueBf16", "bf16 GEMMs (wgmma)"), ("attention_tiled", "attention"),
                ("ln_rowquant", "LayerNorm/rowquant passes"),
                ("ln_cast", "LayerNorm passes"), ("Memcpy", "copies"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc.encode_pixels(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = {}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        family = next((fam for pat, fam in families if pat in e.key), "other kernels")
        ms[family] = ms.get(family, 0.0) + e.self_device_time_total / 1e3
    busy = sum(ms.values())
    if busy <= 0:
        print(f"{label} encode profile: torch.profiler recorded no device time; "
              "device time by kernel not measured", flush=True)
        return
    parts = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(ms.items(), key=lambda kv: -kv[1]))
    print(f"{label} encode profile, one batch of {len(images)} images (padded to {ENC_BUCKET5}), "
          f"torch.profiler on: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms (idle share "
          f"{max(0.0, 1 - busy / wall_ms):.1%}): {parts} [{card}]", flush=True)


def profile_l14_int8_batch(torch, card, times=3):
    """`times` profiles (profile_encode) of one warm L/14 int8 image batch,
    64 seeded images padded to 128, on serving_config(vit_l14()) with seeded
    weights: the batch's device busy time by kernel family. Uses only
    entries older checkouts have, for --time-k1's in-turns reading."""
    from image_retrieval_tpu_torch.config import Config, IndexConfig, serving_config, vit_l14
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    cfg = Config(model=serving_config(vit_l14()),
                 index=IndexConfig(embedding_dim=768, dtype="int8"))
    enc = CLIPEncoder(cfg, seed=0)
    size = cfg.model.image_size
    images = np.random.default_rng(5).integers(0, 256, size=(N_IMAGES5, size, size, 3),
                                               dtype=np.uint8)
    enc.encode_pixels(images[:8])  # the weights' quantization
    enc.encode_pixels(images)
    torch.cuda.synchronize()
    for _ in range(times):
        profile_encode(torch, enc, images, card)
    del enc
    torch.cuda.empty_cache()


def phase_l14(torch, card, queries):
    """The ViT-L/14 serving slice, counted; then its answers against the
    oracle and its towers against the plain versions. Returns the launches
    of K1, K2a and K2b in the counted run, the encoder and the index."""
    from image_retrieval_tpu_torch.app.embed import ImageEmbeddingSystem
    from image_retrieval_tpu_torch.app.search import TextImageSearcher
    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.config import Config, IndexConfig, serving_config, vit_l14
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.clip import KERNEL, LAYER
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    cfg = Config(model=serving_config(vit_l14()),
                 index=IndexConfig(embedding_dim=768, dtype="int8", capacity_step=N5 + 65536))
    mc = cfg.model
    t0 = time.perf_counter()
    enc = CLIPEncoder(cfg, seed=0)  # no device=: the card
    if enc.device.type != "cuda":
        fail(f"CLIPEncoder without device= is on {enc.device}")
    modes = (enc.model.vision.blocks[0].mode, enc.model.text.blocks[0].mode)
    if modes != ((KERNEL, KERNEL), (LAYER, LAYER)):
        fail(f"L/14 towers routed {modes}")
    print(f"CLIPEncoder serving_config(vit_l14()) on {enc.device}: {mc.vision_layers}+"
          f"{mc.text_layers} layers, widths {mc.vision_width}/{mc.text_width}, embed "
          f"{mc.embed_dim}, image {mc.image_size} patch {mc.patch_size}, "
          f"{sum(p.numel() for p in enc.model.parameters()) / 1e6:.0f} M parameters, "
          f"{time.perf_counter() - t0:.1f} s to build", flush=True)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, size=(N_IMAGES5, mc.image_size, mc.image_size, 3),
                          dtype=np.uint8)
    # warm-up (weight quantization of all 36 layers, cuBLAS handles); its
    # launches are not counted
    enc.encode_pixels(images[:8])
    q_emb = enc.encode_texts(queries)
    torch.cuda.synchronize()
    pos, planted = planted_rows(q_emb, np.random.default_rng(6), N5)
    rows = gallery_chunk(torch, 0, mc.embed_dim, pos, planted)
    Index = recording_index(ShardedVectorIndex)

    # ---- the main path, counted ------------------------------------------
    kernels = (fa.layer_block_int8, fa.attention_block_int8, fa.mlp_block_int8)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img_emb = enc.encode_pixels(images)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    system = ImageEmbeddingSystem(enc, index=Index(dim=mc.embed_dim, config=cfg.index),
                                  config=cfg)
    index = system.index
    if index.device.type != "cuda":
        fail(f"ShardedVectorIndex without device= is on {index.device}")
    t0 = time.perf_counter()
    index.insert([f"gallery/{i:07d}" for i in range(N5)], rows,
                 np.random.default_rng(7).uniform(0.5, 4.0, N5).astype(np.float32),
                 attrs={"bucket": np.arange(N5) % 8})  # both for phase 6
    index.insert([f"images/{i:04d}.jpg" for i in range(N_IMAGES5)], img_emb)
    index.load()
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    index.stage = "wave"
    server = SearchServer(enc, index, max_batch=64, max_wait_ms=2.0)
    waves = [serve_wave(server, queries) for _ in range(2)]  # cold, then again
    index.stage = "single"
    searcher = TextImageSearcher(enc, index)
    t0 = time.perf_counter()
    singles = [searcher.search(queries[i], top_k=TOP_K, score_threshold=-1.0)
               for i in range(N_SINGLE5)]
    single_ms = (time.perf_counter() - t0) * 1e3 / N_SINGLE5
    launches = {k.__name__: k.launches for k in kernels}
    # ---- end of the counted run ------------------------------------------
    text_batches = sum(w[2] for w in waves) + N_SINGLE5
    expected = {"layer_block_int8": mc.text_layers * text_batches,
                "attention_block_int8": mc.vision_layers, "mlp_block_int8": mc.vision_layers}
    print(f"launches in the L/14 main path: {launches} (expected {mc.vision_layers} K2a + "
          f"{mc.vision_layers} K2b for the one image batch, {mc.text_layers} K1 x "
          f"{text_batches} text batches = {expected['layer_block_int8']})", flush=True)
    if launches != expected:
        fail("the L/14 main path did not run K2a and K2b once per vision layer per "
             "image batch and K1 once per text layer per text batch")
    if img_emb.shape != (N_IMAGES5, mc.embed_dim) or not np.isfinite(img_emb).all():
        fail(f"image embeddings {img_emb.shape} are not finite ({N_IMAGES5}, {mc.embed_dim})")
    print(f"L/14 image embed: {N_IMAGES5} images (one batch of {ENC_BUCKET5} with padding, "
          f"{ENC_BUCKET5 * 257} token rows) in {embed_s:.3f} s = {N_IMAGES5 / embed_s:.1f} "
          f"img/s, uint8 in, embeddings back on the host; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    (_, cold, cold_b), (_, warm, warm_b) = waves
    print(f"int8 tier: {len(index)} x {mc.embed_dim} rows quantized on the host and "
          f"uploaded in {insert_s:.1f} s ({index._gallery.numel() / 2**30:.2f} GiB on the "
          f"card); {N_CLIENTS} concurrent text queries through SearchServer: cold "
          f"{N_CLIENTS / cold:.1f} QPS ({cold_b} micro-batches), again "
          f"{N_CLIENTS / warm:.1f} QPS ({warm_b} micro-batches); single searches "
          f"{single_ms:.2f} ms each (text tower + sweep, host clock) [{card}]", flush=True)

    # ---- answers vs the float64 oracle -----------------------------------
    check_clients_got_the_indexs_answers("L/14", index, waves)
    for a in singles:
        if len(a) != TOP_K or not all(np.isfinite(h["score"]) for h in a):
            fail(f"single search returned {a!r:.200}")
    worst, recall = check_answers(index, int8_exact_oracle(torch, index, 3 * TOP_K))
    for stage, (n, misses) in recall.items():
        print(f"L/14 int8 tier, {stage}: recall@10 vs the oracle {1 - misses / n:.4f} over "
              f"{n} answers ({misses} misses; limit {RECALL_MIN})", flush=True)
        if 1 - misses / n < RECALL_MIN:
            fail(f"L/14 {stage}: recall@10 below {RECALL_MIN}")
    print(f"L/14 int8 tier vs float64 int8-exact oracle: max score diff {worst:.3g} "
          f"(limit {INT4_ORACLE_ATOL})", flush=True)

    towers_vs_plain(torch, enc, images[:N_CHECK5], queries[:8])
    profile_encode(torch, enc, images, card)
    return launches, enc, index


# ---- phase 6: the weighted and multi-metric path -----------------------------

W_REF = dict(w_angle=1.0, w_l1=1.0, w_l2=1.0, w_inf=0.0, w_mag=0.5)  # reference-style
W_ALL = dict(w_angle=0.3, w_l1=0.2, w_l2=0.5, w_inf=0.7, w_mag=0.1)  # every term live
W_COS = dict(w_angle=1.0, w_l1=0.0, w_l2=0.0, w_inf=0.0, w_mag=0.0)  # the default weights
W_KEYS = ("w_angle", "w_l1", "w_l2", "w_inf", "w_mag")
SLICE6 = 1 << 18  # rows of the kernel-vs-plain comparisons
# A wave: N_PLAIN6 unfiltered requests, the rest of the queries under FLT6,
# and N_OTHER6 more under a second weight set.
N_PLAIN6, N_OTHER6, FLT6 = 48, 8, "bucket == 3"
# Served answers against the float64 oracle: f32 sums over D = 512..768 and
# f32 norms against float64 ones, on scores whose size follows ||q||.
WEIGHTED_ATOL, WEIGHTED_RTOL = 1e-5, 1e-5


def wtuple(w):
    return tuple(float(w[k]) for k in W_KEYS)


class Best:
    """Running best-`depth` (score, row) per query over score chunks, float64,
    lowest row first among equal scores within a chunk."""

    def __init__(self, torch, nq, depth, descending):
        self.torch, self.depth, self.desc = torch, depth, descending
        self.worst = float("-inf") if descending else float("inf")
        self.v = torch.full((nq, depth), self.worst, dtype=torch.float64, device="cuda")
        self.i = torch.full((nq, depth), -1, dtype=torch.int64, device="cuda")

    def add(self, scores, lo, keep=None):
        torch = self.torch
        if keep is not None:
            scores = scores.masked_fill(~keep, self.worst)
        v, i = torch.topk(scores, min(self.depth, scores.shape[1]), dim=1, largest=self.desc)
        v, j = torch.topk(torch.cat([self.v, v], 1), self.depth, dim=1, largest=self.desc)
        self.v, self.i = v, torch.gather(torch.cat([self.i, i + lo], 1), 1, j)


def f64_planes(torch, q, rows, mags):
    """The five metric planes in float64: q (Q, D) against unit rows (n, D)
    scaled by their magnitudes (n,), all double."""
    d = q.shape[1]
    qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    cos = torch.where(qn > 0, (q @ rows.t()) / torch.where(qn > 0, qn, 1.0), 0.0)
    diff = (rows * mags[:, None])[None, :, :] - q[:, None, :]
    ad = diff.abs()
    return {"cosine_similarity": cos, "l1_distance": ad.sum(-1) / d,
            "l2_distance": (diff * diff).sum(-1).sqrt() / d ** 0.5,
            "linf_distance": ad.amax(-1), "magnitude_difference": (mags[None, :] - qn).abs()}


def weighted_f64(planes, w):
    return (w[0] * planes["cosine_similarity"] - w[1] * planes["l1_distance"]
            - w[2] * planes["l2_distance"] - w[3] * planes["linf_distance"]
            - w[4] * planes["magnitude_difference"])


def int8_definition_f64(torch, q, g8, sc, m, w):
    """The int8 scorer's definition in float64 sums: bf16 query, exact
    products, rec = bf16(int8 * bf16(scale * mag)), |bf16(rec - q16)| for
    L1/Linf, the Gram-form L2 through the norm-preserving scales. Only the
    order and width of the sums separate it from the kernel. Returns the
    scores and the Gram sq (both (Q, n) double)."""
    d = q.shape[1]
    qn = torch.linalg.vector_norm(q.double(), dim=1, keepdim=True)
    q16 = q.to(torch.bfloat16)
    udots = (q16.double() @ g8.double().t()) * sc.double()[None, :]
    md = m.double()[None, :]
    sq = (md * md - 2.0 * md * udots + qn * qn).clamp_min(0.0)
    rec = g8.to(torch.bfloat16) * (sc * m).to(torch.bfloat16)[:, None]
    ad = (rec[None, :, :] - q16[:, None, :]).abs()
    score = (w[0] * torch.where(qn > 0, udots / torch.where(qn > 0, qn, 1.0), 0.0)
             - w[2] * sq.sqrt() / d ** 0.5 - w[1] * ad.sum(-1, dtype=torch.float64) / d
             - w[3] * ad.amax(-1).double() - w[4] * (md - qn).abs())
    return score, sq


def oracle_pass(torch, index, q, w, depth, chunk=2048):
    """One float64 pass over the index's host rows for queries q (Q, D) f32
    on the card: the best-`depth` of the weighted score (for an int8 index by
    the int8 scorer's definition, else from the planes) and of each metric
    plane (int8 rows dequantized in f32 as the index does), unfiltered and
    under FLT6. Returns {(name, filtered): Best}, the weighted scores of
    every row (Q, N) double, and their squared distances ||m g - q||^2."""
    nq, n = q.shape[0], len(index)
    quantized = index.config.dtype == "int8"
    live = torch.from_numpy(index.live_mask()).cuda()
    flt = torch.from_numpy(index.filter_mask(FLT6)).cuda()
    names = ("optimized_similarity", "cosine_similarity", "l1_distance", "l2_distance",
             "linf_distance", "magnitude_difference")
    best = {(name, f): Best(torch, nq, depth, name in ("optimized_similarity",
                                                       "cosine_similarity"))
            for name in names for f in (False, True)}
    full = torch.empty((nq, n), dtype=torch.float64, device="cuda")
    full_sq = torch.empty((nq, n), dtype=torch.float64, device="cuda")
    qd = q.double()
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        m = torch.from_numpy(index._host_mags[lo:hi]).cuda()
        if quantized:
            g8 = torch.from_numpy(index._host_gallery[lo:hi]).cuda()
            sc = torch.from_numpy(index._host_scales[lo:hi]).cuda()
            rows = (g8.to(torch.float32) * sc[:, None]).double()
        else:
            rows = torch.from_numpy(index._host_gallery[lo:hi]).cuda().double()
        planes = f64_planes(torch, qd, rows, m.double())
        if quantized:
            planes["optimized_similarity"], full_sq[:, lo:hi] = int8_definition_f64(
                torch, q, g8, sc, m, w)
        else:
            planes["optimized_similarity"] = weighted_f64(planes, w)
            full_sq[:, lo:hi] = planes["l2_distance"] ** 2 * q.shape[1]
        full[:, lo:hi] = planes["optimized_similarity"]
        for name in names:
            best[(name, False)].add(planes[name], lo, live[lo:hi])
            best[(name, True)].add(planes[name], lo, flt[lo:hi])
    return best, full, full_sq


def check_ranked(what, vals, idx, best, rows=None, slack=None):
    """Served (scores, ids) of queries `rows` (default: all) against an
    oracle Best one deeper: every score within the limit of the oracle's at
    its rank, ids identical except where the oracle's neighbouring scores
    differ by no more than the limit. `slack` (Q, depth) widens the limit
    (the Gram-form L2 at a cancellation). Returns (worst |diff|, swaps)."""
    ov, oi = best.v.cpu().numpy(), best.i.cpu().numpy()
    sl = None if slack is None else slack.cpu().numpy()
    rows = range(len(vals)) if rows is None else rows
    worst, swaps = 0.0, 0
    for a, qrow in enumerate(rows):
        k = vals.shape[1]
        if not np.isfinite(vals[a]).all() or (idx[a] < 0).any():
            fail(f"{what} query {qrow}: padding or non-finite scores in a full answer")
        lim = WEIGHTED_ATOL + WEIGHTED_RTOL * np.abs(ov[qrow, :k + 1])
        if sl is not None:
            lim = lim + sl[qrow, :k + 1]
        diff = np.abs(vals[a] - ov[qrow, :k])
        worst = max(worst, float(diff.max()))
        if (diff > lim[:k]).any():
            fail(f"{what} query {qrow}: scores {vals[a]} vs oracle {ov[qrow, :k]} "
                 f"(limit {lim[:k]})")
        for r in np.flatnonzero(idx[a] != oi[qrow, :k]):
            gaps = [abs(ov[qrow, r] - ov[qrow, o]) for o in (r - 1, r + 1) if o >= 0]
            if min(gaps) > 2 * lim[r]:
                fail(f"{what} query {qrow} rank {r}: id {idx[a][r]} != oracle {oi[qrow, r]} "
                     f"with gaps {gaps} (limit {lim[r]:.3g})")
            swaps += 1
    return worst, swaps


def answers_to_arrays(index, answers):
    """Served [{'path', 'score'}] lists -> (scores, row ids) arrays."""
    path_id = {p: i for i, p in enumerate(index.paths)}
    vals = np.array([[h["score"] for h in a] for a in answers], np.float64)
    return vals, np.array([[path_id[h["path"]] for h in a] for a in answers])


def gram_slack(fm, sq, m, qn, d, w_l2):
    """|w_l2| x how far a Gram-form L2 / sqrt(d) may move where its float64
    sq, row magnitude and query norm are (sq, m, qn): fused_metrics'
    gram_l2_slack for gathered entries."""
    delta = fm.GRAM_SQ_RTOL * (m ** 2 + qn ** 2)
    return abs(w_l2) * ((sq + delta).sqrt() - (sq - delta).clamp_min(0.0).sqrt()) / d ** 0.5


def plant_rows(torch, index, q_emb, seed):
    """Append to `index`, per query embedding: one row equal to it (an image
    searched by its own embedding) and PLANTED4 neighbours at cosines
    0.3-0.95 with magnitudes in [0.5, 4]. Returns the first planted row."""
    rng = np.random.default_rng(seed)
    first = len(index)
    index.insert([f"self/{i:02d}" for i in range(len(q_emb))], q_emb,
                 attrs={"bucket": (first + np.arange(len(q_emb))) % 8})
    _, near = planted_rows(q_emb, rng, len(q_emb) * PLANTED4)
    at = len(index) + np.arange(len(near))
    index.insert([f"near/{i:04d}" for i in range(len(near))], near,
                 rng.uniform(0.5, 4.0, len(near)).astype(np.float32),
                 attrs={"bucket": at % 8})
    index.load()
    torch.cuda.synchronize()
    return first


def metric_kernels_vs_plain(torch, g32, m32, q32, g8, sc8, m8, q8):
    """K7, K6, K4 and K5 against their plain versions on the card, on the
    last SLICE6 rows of the two galleries (they hold the planted rows, one
    equal to each query), at Q = 1 and 64. Returns the worst |kernel - plain|
    per kernel."""
    from image_retrieval_tpu_torch.index.vector_index import quantize_int8
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops import metrics as M

    worst = dict.fromkeys(("fused_all_metrics", "fused_optimized_scores",
                           "fused_optimized_topk", "fused_optimized_scores_int8"), 0.0)

    def slack(q, unit_dots, m, d):
        qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
        return fm.gram_l2_slack(M.gram_sq(m, unit_dots, qn), m, qn, d)

    def agree(kernel, case, got, want, limit):
        torch.cuda.synchronize()
        r = fm.scores_agree(got, want, limit)
        print(f"kernel-vs-plain {kernel} {case}: max_abs_err {r['max_abs_err']:.3g}, "
              f"worst error/limit {r['worst_ratio']:.3g} (limit 1)", flush=True)
        if not r["ok"]:
            fail(f"{kernel} {case} disagrees with its plain version")
        worst[kernel] = max(worst[kernel], r["max_abs_err"])

    g, m = g32[-SLICE6:], m32[-SLICE6:]
    d = g.shape[1]
    for nq in (1, 64):
        q = q32[-nq:].contiguous()  # the planted rows equal to these queries are in the slice
        l2s = slack(q, q @ g.t(), m, d)
        want = fm.fused_all_metrics_reference(q, g, m)
        got = fm.fused_all_metrics(q, g, m)
        agree("fused_all_metrics", f"Q={nq} {SLICE6}x{d} f32", got, want, fm.score_limit(want))
        if not (torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])):
            fail("fused_all_metrics: Linf and |dmag| are not the plain version's bits")
        del got, want
        for name, w in (("all-live", W_ALL), ("reference", W_REF)):
            wt = torch.tensor(wtuple(w), device="cuda")
            want = fm.fused_optimized_scores_reference(q, g, m, wt)
            agree("fused_optimized_scores", f"Q={nq} {SLICE6}x{d} f32 {name}",
                  fm.fused_optimized_scores(q, g, m, wt), want,
                  fm.score_limit(want, w["w_l2"], l2s))
        # K4: a gallery that is no multiple of the tile, f32 and bf16 rows
        n4 = SLICE6 - 37
        for rows_name, rows in (("f32", g[-n4:]), ("bf16", g[-n4:].to(torch.bfloat16))):
            unit = rows.float()
            l2k = slack(q, q @ unit.t(), m[-n4:], d)
            for name, w in (("all-live", W_ALL), ("reference", W_REF), ("cosine-only", W_COS)):
                plain = M.fused_optimized_scores_xla(q, rows, m[-n4:], wtuple(w), exact_l2=False)
                lim = fm.score_limit(plain, w["w_l2"], l2k)
                for k in (10, 64):
                    got_v, got_i = fm.fused_optimized_topk(q, rows, m[-n4:], wtuple(w), k=k)
                    want_v, want_i = fm.fused_optimized_topk_reference(q, rows, m[-n4:],
                                                                       wtuple(w), k=k)
                    torch.cuda.synchronize()
                    r = fm.topk_agree(got_v, got_i, want_v, want_i.to(torch.int64), plain, lim)
                    print(f"kernel-vs-plain fused_optimized_topk Q={nq} {n4}x{d} {rows_name} "
                          f"{name} k={k}: max_abs_err {r['max_abs_err']:.3g}, {r['swaps']} "
                          f"near-tie swaps", flush=True)
                    if not r["ok"]:
                        fail(f"fused_optimized_topk Q={nq} {rows_name} {name} k={k}: {r['why']}")
                    worst["fused_optimized_topk"] = max(worst["fused_optimized_topk"],
                                                        r["max_abs_err"])
                del plain, lim
        # fewer finite scores than k: rows of infinite magnitude score -inf
        # and are still returned under their own row numbers, lowest first
        minf = m[-n4:].clone()
        minf[40:] = float("inf")
        w = (1.0, 0.0, 0.0, 0.0, 0.5)
        got_v, got_i = fm.fused_optimized_topk(q, g[-n4:], minf, w, k=64)
        want_v, want_i = fm.fused_optimized_topk_reference(q, g[-n4:], minf, w, k=64)
        if not (torch.equal(got_i, want_i) and bool(torch.isneginf(got_v[:, 40:]).all())
                and torch.equal(torch.isneginf(got_v), torch.isneginf(want_v))):
            fail(f"fused_optimized_topk Q={nq}: rows scoring -inf are not returned as the "
                 "plain version returns them")
    # K5 at D = 768 (the int8 gallery) and D = 512 (the f32 slice, quantized)
    h8, hs = quantize_int8(g.cpu().numpy())
    for d8, rows8, sc, m, qs in ((g8.shape[1], g8[-SLICE6:], sc8[-SLICE6:], m8[-SLICE6:], q8),
                                 (d, torch.from_numpy(h8).cuda(), torch.from_numpy(hs).cuda(),
                                  m, q32)):
        for nq in (1, 64):
            q = qs[-nq:].contiguous()
            q16 = q.to(torch.bfloat16).float()
            l2s = slack(q, (q16 @ rows8.float().t()) * sc, m, d8)
            for name, w in (("reference", W_REF), ("default", W_COS), ("all-live", W_ALL)):
                want = fm.fused_optimized_scores_int8_reference(q, rows8, sc, m, wtuple(w))
                agree("fused_optimized_scores_int8", f"Q={nq} {SLICE6}x{d8} {name}",
                      fm.fused_optimized_scores_int8_pallas(q, rows8, sc, m, wtuple(w)), want,
                      fm.score_limit(want, w["w_l2"], l2s))
            linf = (0.0, 0.0, 0.0, 1.0, 0.0)
            if not torch.equal(
                    fm.fused_optimized_scores_int8_pallas(q, rows8, sc, m, linf),
                    fm.fused_optimized_scores_int8_reference(q, rows8, sc, m, linf)):
                fail(f"fused_optimized_scores_int8 Q={nq} D={d8}: Linf is not the plain "
                     "version's bits")
    print("fused_optimized_scores_int8: Linf alone equals the plain version bit for bit at "
          "D = 768 and 512, Q = 1 and 64", flush=True)
    return worst


def sweep_slots(w, int8=False, tensor=False):
    """f32 CUDA-core slots per (query, row, dim) that the weighted score
    needs under weights `w` (a dict; None: weights read at run time, so every
    term is computed): one FMA for the product where the cosine or the
    Gram-form L2 is live; where L1 or Linf is live one subtract, then one add
    for L1 and one max for Linf, each only if its weight is not 0. Over int8
    rows (K5) the product and the L1 sum are tensor-core work (k5_bounds) and
    are not counted here, and the subtract (with its rounding) and the max
    are bf16 operations at the packed rate, BF16_SLOT each. `tensor`: the
    product runs on the tensor cores in split TF32 (the f32 sweep of K4, K6
    and K7 since PR 16; f32_bounds) and takes no slot here."""
    live = [True] * 5 if w is None else [x != 0.0 for x in wtuple(w)]
    slots = 0.0 if int8 or tensor or not (live[0] or live[2]) else 1.0
    if live[1] or live[3]:
        narrow = BF16_SLOT if int8 else 1.0
        slots += narrow + (1.0 if live[1] and not int8 else 0.0) + (narrow if live[3] else 0.0)
    return slots


def f32_bounds(w, nq, n, d, row_bytes, out_bytes, planes=False):
    """The bound of K4, K6 or K7 on these shapes, and the bound as PRs 4-15
    counted it. Bytes: the rows (row_bytes a value), magnitudes, f32 queries
    and `out_bytes` of output once. Operations per (query, row, dim):
    sweep_slots(tensor=True) on the CUDA cores (and K6's direct-L2 FMA,
    `planes`); where the cosine or the L2 is live, the product in split TF32
    on the tensor cores, 3 products of 2 flops over f32 rows, 2 over bf16
    rows (a bf16 value is a TF32 value). The old count took the product as
    one f32 FMA slot."""
    live = [True] * 5 if w is None else [x != 0.0 for x in wtuple(w)]
    el = float(nq) * n * d
    nbytes = n * (d * row_bytes + 4) + nq * d * 4 + out_bytes
    extra = 1.0 if planes else 0.0
    tf32 = (6.0 if row_bytes == 4 else 4.0) * el if live[0] or live[2] else 0.0
    new = bound(0.0, 0.0, nbytes, (sweep_slots(w, tensor=True) + extra) * el, tf32)
    old = bound(0.0, 0.0, nbytes, (sweep_slots(w) + extra) * el)
    return new, old


def k5_bounds(w, nq, n, d):
    """K5's bound on these shapes, and the bound as PRs 4-10 counted it.
    Bytes: the int8 rows, scales, magnitudes, f32 queries and the (Q, N) f32
    output once. Operations per (query, row, dim): sweep_slots(int8=True) on
    the CUDA cores; at the bf16 tensor-core peak 2 for the product where the
    cosine or the L2 is live and 2 for the L1 sum where L1 is (a multiply-add
    by one: K5 sums |u - q| on the tensor cores). The old count took the L1
    sum as one f32 add on the CUDA cores."""
    live = [x != 0.0 for x in wtuple(w)]
    el = float(nq) * n * d
    nbytes = n * (d + 4 + 4) + nq * d * 4 + nq * n * 4
    dot = 2.0 * el if live[0] or live[2] else 0.0
    new = bound(0.0, dot + (2.0 * el if live[1] else 0.0), nbytes, sweep_slots(w, True) * el)
    old = bound(0.0, dot, nbytes, (sweep_slots(w, True) + (1.0 if live[1] else 0.0)) * el)
    return new, old


# K5's three timed cases (the int8 tier's served weight sets at Q = 1 and 64)
K5_CASES = ((1, "default", W_COS), (64, "default", W_COS), (64, "reference", W_REF))


def time_k5(torch, card, g8, sc8, m8, q8, device=False):
    """K5 beside its plain version over the whole int8 gallery in its three
    cases: ms (CUDA events, in turns with the plain version), the bound now
    and as counted before, the share of the bound, and with `device` the
    device time of one call (torch.profiler: the kernel and the query norms;
    only in --time-metrics, so that no profiler runs between the phases)."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    out = {}
    n, d = g8.shape
    for nq, name, w in K5_CASES:
        q = q8[:nq].contiguous()
        fns = {"kernel": lambda: fm.fused_optimized_scores_int8_pallas(q, g8, sc8, m8, wtuple(w)),
               "plain": lambda: fm.fused_optimized_scores_int8_reference(q, g8, sc8, m8,
                                                                         wtuple(w))}
        big = nq * n * d > 1 << 32
        t = time_pair(torch, fns, samples=4 if big else 12, reps=1 if big else 3,
                      warm=1 if big else 2)
        b, old = k5_bounds(w, nq, n, d)
        out[f"q{nq}-{name}"] = dict(t, **b, old_bound_ms=old["bound_ms"],
                                    shape=f"Q{nq} x {n} rows x {d}")
        dev = ""
        if device:
            ms = out[f"q{nq}-{name}"]["device_ms"] = device_ms(torch, fns["kernel"])
            dev = f" (device {ms if ms is None else round(ms, 4)})"
        print(f"time fused_optimized_scores_int8 q{nq}-{name} Q={nq} over {n} x {d}: kernel "
              f"{t['kernel']:.4f} ms{dev}, plain "
              f"{t['plain']:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
              f"{100 * b['bound_ms'] / t['kernel']:.1f} % of it), bound as counted before "
              f"{old['bound_ms']:.4f} ms ({old['bound_by']}) [{card}]", flush=True)
    return out


def k5_gallery(torch, n=1_049_728, d=768, nq=64, seed=11):
    """A seeded gallery of the L/14 int8 tier's shape on the card: unit rows
    quantized as the index quantizes them (absmax/127 grid, norm-preserving
    scales), magnitudes in [0.5, 4], and nq unnormalized queries."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g8 = torch.empty((n, d), dtype=torch.int8, device="cuda")
    sc = torch.empty(n, dtype=torch.float32, device="cuda")
    for lo in range(0, n, 1 << 17):
        x = torch.randn((min(n, lo + (1 << 17)) - lo, d), generator=gen, device="cuda")
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        grid = x.abs().amax(dim=1, keepdim=True) / 127.0
        r = torch.clamp(torch.round(x / grid), -127, 127)
        g8[lo:lo + len(x)] = r.to(torch.int8)
        sc[lo:lo + len(x)] = 1.0 / torch.linalg.vector_norm(r, dim=1)
    m = torch.rand(n, generator=gen, device="cuda") * 3.5 + 0.5
    q = torch.randn((nq, d), generator=gen, device="cuda") * 0.4
    return g8, sc, m, q


def f32_gallery(torch, n=1_001_344, d=512, nq=64, seed=12):
    """A seeded gallery of phase 6's f32 shape on the card: unit rows,
    magnitudes in [0.5, 4], and nq unnormalized queries."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.empty((n, d), dtype=torch.float32, device="cuda")
    for lo in range(0, n, 1 << 17):
        x = torch.randn((min(n, lo + (1 << 17)) - lo, d), generator=gen, device="cuda")
        g[lo:lo + len(x)] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    m = torch.rand(n, generator=gen, device="cuda") * 3.5 + 0.5
    q = torch.randn((nq, d), generator=gen, device="cuda") * 0.4
    return g, m, q


# the metric kernels' mangled names as ptxas reports them: the f32 sweep (and
# the CUDA-core kernels it replaced, for a run from an older checkout), K5
METRIC_KERNEL_NAMES = ("f32_sweep_kernel", "all_metrics_kernel", "optimized_scores_kernel",
                       "optimized_topk_kernel", "optimized_scores_int8_kernel")


# f32 sweep instantiations (f32_sweep_form) known to spill, each with why it
# stands: a spill in any other fails print_metric_registers
F32_KNOWN_SPILLS = {
    # K4 with the cosine and Linf live, L1 and the Gram-form L2 dead: no main
    # path launches it (phase 6's K4 takes the reference weights)
    "K4 f32 qw8 dot1 l1=0 linf=1",
}


def f32_sweep_form(name):
    """'K4 f32 qw8 dot2 l1=1 linf=0' for a mangled f32_sweep_kernel name
    (dot: 1 split TF32 on the tensor cores, 2 the CUDA cores), else None."""
    import re

    m = re.search(r"f32_sweep_kernelILi(\d)E(f|13__nv_bfloat16)Li(\d+)EL[ib](\d)ELb(\d)ELb(\d)E",
                  name)
    if not m:
        return None
    kind, rows, qw, dot, l1, linf = m.groups()
    return (f"{('K6', 'K7', 'K4')[int(kind)]} {'f32' if rows == 'f' else 'bf16'} qw{qw} "
            f"dot{dot} l1={l1} linf={linf}")


def print_metric_registers(lib_path):
    """ptxas's registers and spills of every instantiation of the four
    metric kernels (K4, K6, K7 on the f32 sweep; K5); fails on a spill in
    an f32 sweep instantiation that F32_KNOWN_SPILLS does not list."""
    import re

    found = 0
    for pattern in METRIC_KERNEL_NAMES:
        for name, line in sorted(ptxas_report(lib_path, pattern).items()):
            form = f32_sweep_form(name)
            short = form or re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "", name)[:90]
            print(f"metric kernel {short} ptxas: {line}", flush=True)
            found += 1
            if (form and form not in F32_KNOWN_SPILLS
                    and any(int(x) for x in re.findall(r"(\d+) bytes spill", line))):
                fail(f"f32 sweep {form} spills: {line}")
    if not found:
        fail("build.log holds no metric kernel")


def print_f32_plan(fm, label, nq, n, d, w, row_bytes=4, k=0):
    """The f32 sweep's plan for one timed shape (w None: K6 / K7)."""
    if not hasattr(fm, "f32_sweep_plan"):  # an older checkout: no f32 sweep
        return
    import dataclasses

    p = fm.f32_sweep_plan(nq, n, d, None if w is None else wtuple(w), row_bytes, k)
    print(f"f32 sweep plan {label} Q={nq} over {n} x {d}: {dataclasses.asdict(p)}", flush=True)


def metric_edges_vs_plain(torch):
    """K6, K7 and K4 against their plain versions at the f32 sweep's edges:
    Q = 1, 8, 33, 64, 65 (one query, a unit, a ragged group, a pass, two
    passes), D = 512, 768 and 37 (odd: the copying producer), N = 9 (below a
    unit) and 3001; K4 over f32 and bf16 rows under three weight sets at
    k = 1, 10, 64; K6's Linf and |dmag| planes bit for bit; K4's rows
    scoring -inf at Q = 1 and 64."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops import metrics as M

    gen = torch.Generator(device="cuda").manual_seed(21)
    worst = {"fused_all_metrics": 0.0, "fused_optimized_scores": 0.0, "fused_optimized_topk": 0.0}
    cases = dict.fromkeys(worst, 0)

    def note(kernel, ratio):
        worst[kernel] = max(worst[kernel], ratio)
        cases[kernel] += 1

    def slack(q, rows, m, d):
        qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
        return fm.gram_l2_slack(M.gram_sq(m, q @ rows.float().t(), qn), m, qn, d)

    for d in (512, 768, 37):
        for n in (9, 3001):
            g = torch.randn((n, d), generator=gen, device="cuda")
            g /= torch.linalg.vector_norm(g, dim=1, keepdim=True)
            m = torch.rand(n, generator=gen, device="cuda") * 3.5 + 0.5
            for nq in (1, 8, 33, 64, 65):
                q = torch.randn((nq, d), generator=gen, device="cuda") * 0.4
                q[-1] = g[5] * m[5]  # a query equal to a stored row
                case = f"Q={nq} {n}x{d}"
                want = fm.fused_all_metrics_reference(q, g, m)
                got = fm.fused_all_metrics(q, g, m)
                r = fm.scores_agree(got, want, fm.score_limit(want))
                if not r["ok"]:
                    fail(f"fused_all_metrics {case} disagrees with its plain version: {r}")
                if not (torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])):
                    fail(f"fused_all_metrics {case}: Linf and |dmag| are not the plain "
                         "version's bits")
                note("fused_all_metrics", r["worst_ratio"])
                for w in (W_ALL, W_REF):
                    wt = torch.tensor(wtuple(w), device="cuda")
                    want = fm.fused_optimized_scores_reference(q, g, m, wt)
                    r = fm.scores_agree(fm.fused_optimized_scores(q, g, m, wt), want,
                                        fm.score_limit(want, w["w_l2"], slack(q, g, m, d)))
                    if not r["ok"]:
                        fail(f"fused_optimized_scores {case} {w}: {r}")
                    note("fused_optimized_scores", r["worst_ratio"])
                for rows in (g, g.to(torch.bfloat16)):
                    l2s = slack(q, rows, m, d)
                    for w in (W_COS, W_REF, W_ALL):
                        plain = M.fused_optimized_scores_xla(q, rows, m, wtuple(w),
                                                             exact_l2=False)
                        lim = fm.score_limit(plain, w["w_l2"], l2s)
                        for k in (1, 10, 64):
                            got_v, got_i = fm.fused_optimized_topk(q, rows, m, wtuple(w), k=k)
                            want_v, want_i = fm.fused_optimized_topk_reference(q, rows, m,
                                                                               wtuple(w), k=k)
                            r = fm.topk_agree(got_v, got_i, want_v, want_i.to(torch.int64),
                                              plain, lim)
                            if not r["ok"]:
                                fail(f"fused_optimized_topk {case} {rows.dtype} {w} k={k}: "
                                     f"{r['why']}")
                            note("fused_optimized_topk", r["max_abs_err"] / float(lim.max()))
        # rows of infinite magnitude score -inf and are still returned under
        # their own row numbers, lowest first
        for nq in (1, 64):
            q = torch.randn((nq, d), generator=gen, device="cuda") * 0.4
            minf = m.clone()
            minf[40:] = float("inf")
            for rows in (g, g.to(torch.bfloat16)):
                w = (1.0, 0.0, 0.0, 0.0, 0.5)
                got_v, got_i = fm.fused_optimized_topk(q, rows, minf, w, k=64)
                want_v, want_i = fm.fused_optimized_topk_reference(q, rows, minf, w, k=64)
                if not (torch.equal(got_i, want_i) and bool(torch.isneginf(got_v[:, 40:]).all())
                        and torch.equal(torch.isneginf(got_v), torch.isneginf(want_v))):
                    fail(f"fused_optimized_topk Q={nq} D={d} {rows.dtype}: rows scoring -inf "
                         "are not returned as the plain version returns them")
    torch.cuda.synchronize()
    print("kernel-vs-plain at the f32 sweep's edges (Q 1, 8, 33, 64, 65; D 512, 768, 37; N 9, "
          "3001; K4 f32 and bf16 rows, k 1, 10, 64; -inf rows at Q 1 and 64): "
          + ", ".join(f"{k} {cases[k]} cases, worst error/limit {worst[k]:.3g}" for k in worst)
          + "; K6's Linf and |dmag| bit for bit", flush=True)


def k5_vs_plain(torch, g8, sc, m):
    """K5 against its plain version on 2^16 rows of a seeded gallery: every
    weight set of phase 6 at Q = 1 and 64, Linf alone bit for bit."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops import metrics as M

    rows, s, mm = g8[-(1 << 16):], sc[-(1 << 16):], m[-(1 << 16):]
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn((64, g8.shape[1]), generator=gen, device="cuda") * 0.4
    for nq in (1, 64):
        qq = q[:nq].contiguous()
        qn = torch.linalg.vector_norm(qq, dim=1, keepdim=True)
        unit = (qq.to(torch.bfloat16).float() @ rows.float().t()) * s
        slack = fm.gram_l2_slack(M.gram_sq(mm, unit, qn), mm, qn, rows.shape[1])
        for name, w in (("reference", W_REF), ("default", W_COS), ("all-live", W_ALL)):
            want = fm.fused_optimized_scores_int8_reference(qq, rows, s, mm, wtuple(w))
            got = fm.fused_optimized_scores_int8_pallas(qq, rows, s, mm, wtuple(w))
            torch.cuda.synchronize()
            r = fm.scores_agree(got, want, fm.score_limit(want, w["w_l2"], slack))
            print(f"kernel-vs-plain fused_optimized_scores_int8 Q={nq} {len(rows)}x768 {name}: "
                  f"max_abs_err {r['max_abs_err']:.3g}, worst error/limit "
                  f"{r['worst_ratio']:.3g}", flush=True)
            if not r["ok"]:
                fail(f"fused_optimized_scores_int8 Q={nq} {name} disagrees with its plain version")
        linf = (0.0, 0.0, 0.0, 1.0, 0.0)
        if not torch.equal(fm.fused_optimized_scores_int8_pallas(qq, rows, s, mm, linf),
                           fm.fused_optimized_scores_int8_reference(qq, rows, s, mm, linf)):
            fail(f"fused_optimized_scores_int8 Q={nq}: Linf is not the plain version's bits")


def phase_time_metrics(torch, card, lib_path):
    """--time-metrics: the four metric kernels alone. Registers and spills of
    every instantiation; K4, K6, K7 against their plain versions at the f32
    sweep's edges and K5 on 2^16 rows; then, over seeded galleries of phase
    6's shapes (1,001,344 x 512 f32, 1,049,728 x 768 int8), every kernel's
    event and device times at Q = 1 and 64 beside its plain version and its
    bound (now and as counted before), the f32 sweep's plans, the index's
    two-call cosine sweep beside K4, K6 on one 65,536-row block of
    the int8 tier and the int8 tier's whole multi-metric call with its
    device breakdown. It uses only entries older checkouts have: to compare two
    checkouts in one call, copy this script into each and run it there in
    turns."""
    from image_retrieval_tpu_torch.parallel.collectives import sharded_multimetric_topk

    print_metric_registers(lib_path)
    metric_edges_vs_plain(torch)
    g8, sc, m8, q8 = k5_gallery(torch)
    k5_vs_plain(torch, g8, sc, m8)
    g32, m32, q32 = f32_gallery(torch)
    valid = torch.ones(len(g8), dtype=torch.bool, device="cuda")
    time_metric_kernels(torch, card, g32, m32, q32, g8, sc, m8, q8, device=True,
                        multimetric=lambda q: sharded_multimetric_topk(q, g8, valid, m8, TOP_K,
                                                                        sc))


def device_breakdown(torch, fn, calls=5):
    """{kernel name: device ms a call} of fn under torch.profiler, after one
    warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0}


def call_gap_ms(torch, fn, calls=10):
    """The device's idle time inside one call of fn: from the start of its
    first kernel to the end of its last, less the kernels' own times (the
    host's work between its launches, where the host is the slower), median
    over `calls` calls with a synchronize between them, under
    torch.profiler; None when the profiler records no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA")
    if not spans or len(spans) % calls:
        return None
    per = len(spans) // calls
    gaps = [(grp[-1][1] - grp[0][0] - sum(b - a for a, b in grp)) / 1e3
            for grp in (spans[i:i + per] for i in range(0, len(spans), per))]
    return float(np.median(gaps))


def time_metric_kernels(torch, card, g32, m32, q32, g8, sc8, m8, q8, device=False,
                        multimetric=None):
    """The four kernels beside their plain versions and their bounds over the
    whole galleries, at Q = 1 and 64: CUDA-event ms in turns with the plain
    version and, with `device`, the device ms of one call (torch.profiler:
    every kernel of the call), one call alone by events and the device's
    idle time between its launches (call_gap_ms); bounds by f32_bounds (now and as counted
    before) and k5_bounds (time_k5). Then K6 on one 65,536-row block of the
    int8 tier as sharded_multimetric_topk hands it over (rows dequantized to
    f32), and `multimetric(q)`, the int8 tier's whole multi-metric call, by
    event and device time with K6's share of the latter."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops.topk import exact_topk_wide

    out = {}

    def run(kernel, case, fns, nq, n, d, bounds):
        big = nq * n * d > 1 << 32
        t = time_pair(torch, fns, samples=4 if big else 12, reps=1 if big else 3,
                      warm=1 if big else 2)
        b, old = bounds
        r = out.setdefault(kernel, {})[case] = dict(t, **b, old_bound_ms=old["bound_ms"],
                                                     shape=f"Q{nq} x {n} rows x {d}")
        dev = ""
        if device:
            ms = r["device_ms"] = device_ms(torch, fns["kernel"], calls=5 if big else 20)
            one = r["single_call_ms"] = event_ms(torch, fns["kernel"], samples=15, reps=1)
            gap = r["call_gap_ms"] = call_gap_ms(torch, fns["kernel"])
            dev = (f" (device {ms if ms is None else round(ms, 4)}; one call alone {one:.4f} ms "
                   f"by events, of it the device idle between its launches "
                   f"{gap if gap is None else round(gap, 4)} ms)")
        print(f"time {kernel} {case} Q={nq} over {n} x {d}: kernel {t['kernel']:.4f} ms{dev}, "
              f"plain {t['plain']:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
              f"{100 * b['bound_ms'] / t['kernel']:.1f} % of it), bound as counted before "
              f"{old['bound_ms']:.4f} ms ({old['bound_by']}) [{card}]", flush=True)

    n, d = g32.shape
    w_all = torch.tensor(wtuple(W_ALL), device="cuda")
    for nq in (1, 64):
        q = q32[:nq].contiguous()
        print_f32_plan(fm, "K6 / K7", nq, n, d, None)
        run("fused_optimized_scores", f"q{nq}-all-live", {
            "kernel": lambda: fm.fused_optimized_scores(q, g32, m32, w_all),
            "plain": lambda: fm.fused_optimized_scores_reference(q, g32, m32, w_all),
        }, nq, n, d, f32_bounds(None, nq, n, d, 4, nq * n * 4))
        run("fused_all_metrics", f"q{nq}", {
            "kernel": lambda: fm.fused_all_metrics(q, g32, m32),
            "plain": lambda: fm.fused_all_metrics_reference(q, g32, m32),
        }, nq, n, d, f32_bounds(None, nq, n, d, 4, 5 * nq * n * 4, planes=True))
        for name, w in (("cosine-only", W_COS), ("reference", W_REF)):
            print_f32_plan(fm, f"K4 {name} k={TOP_K}", nq, n, d, w, 4, TOP_K)
            run("fused_optimized_topk", f"q{nq}-{name}", {
                "kernel": lambda: fm.fused_optimized_topk(q, g32, m32, wtuple(w), k=TOP_K),
                "plain": lambda: fm.fused_optimized_topk_reference(q, g32, m32, wtuple(w),
                                                                   k=TOP_K),
            }, nq, n, d, f32_bounds(w, nq, n, d, 4, 2 * nq * TOP_K * 4))
        # beside K4 cosine-only, used by nothing: the index's own cosine sweep
        # (one product and the wide top-k: two calls)
        qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
        t = time_pair(torch, {
            "kernel": lambda: fm.fused_optimized_topk(q, g32, m32, wtuple(W_COS), k=TOP_K),
            "plain": lambda: exact_topk_wide((q @ g32.t()) / qn, TOP_K),
        }, samples=12, reps=3, warm=2)
        out["fused_optimized_topk"][f"q{nq}-cosine-only"]["index_sweep_ms"] = t["plain"]
        print(f"cosine top-{TOP_K} at Q={nq} over {n} x {d} f32: K4 {t['kernel']:.4f} ms, the "
              f"index's sweep (q @ rows.T, exact_topk_wide) {t['plain']:.4f} ms, in turns "
              f"[{card}]", flush=True)
    out["fused_optimized_scores_int8"] = time_k5(torch, card, g8, sc8, m8, q8, device=device)
    # the int8 tier's multi-metric route: K6 on each 65,536-row block of rows
    # dequantized to f32 (parallel/collectives.py sharded_multimetric_topk)
    blk = 1 << 16
    rows = g8[:blk].to(torch.float32) * sc8[:blk, None]
    d8 = rows.shape[1]
    mm = {}
    for nq in (1, 64):
        q = q8[:nq].contiguous()
        print_f32_plan(fm, "K6 int8-tier block", nq, blk, d8, None)
        run("fused_all_metrics", f"int8-block-q{nq}", {
            "kernel": lambda: fm.fused_all_metrics(q, rows, m8[:blk]),
            "plain": lambda: fm.fused_all_metrics_reference(q, rows, m8[:blk]),
        }, nq, blk, d8, f32_bounds(None, nq, blk, d8, 4, 5 * nq * blk * 4, planes=True))
        if multimetric is not None:
            ms = event_ms(torch, lambda: multimetric(q), samples=5, reps=2, warm=1)
            by = device_breakdown(torch, lambda: multimetric(q), calls=3)
            k6 = sum(v for k, v in by.items() if any(s in k for s in ("f32_sweep_kernel",
                                                                      "all_metrics_kernel")))
            busy = sum(by.values())
            top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
            mm[f"q{nq}"] = {"ms": ms, "device_ms": busy, "k6_device_ms": k6}
            print(f"multi_metric_topk, int8 tier, Q={nq} over {len(g8)} x {d8} "
                  f"({-(-len(g8) // blk)} blocks of {blk}): {ms:.4f} ms (events), device "
                  f"{busy:.4f} ms, of it K6 {k6:.4f} ({100 * k6 / busy:.1f} %); largest: "
                  + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top) + f" [{card}]", flush=True)
    out["multi_metric_topk_int8"] = mm
    return out


def phase_weighted(torch, card, enc32, index32, enc14, index14, queries):
    """Phase 6: weighted and multi-metric retrieval through the normal entry
    points on the f32 gallery of phase 3 and the int8 gallery of phase 5,
    counted; every answer against a float64 oracle; the four metric kernels
    against their plain versions and beside their bounds. Returns
    (launches, worst kernel-vs-plain errors, times)."""
    from image_retrieval_tpu_torch.app.search import TextImageSearcher
    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.parallel.collectives import ROW_BLOCK

    emb = {32: enc32.encode_texts(queries), 14: enc14.encode_texts(queries)}  # unnormalized
    index14.stage = "phase 6"
    first = {32: plant_rows(torch, index32, emb[32], 61),
             14: plant_rows(torch, index14, emb[14], 62)}
    qdev = {k: torch.from_numpy(v).cuda() for k, v in emb.items()}
    norms = np.linalg.norm(emb[32], axis=1)
    print(f"phase 6 galleries: f32 {len(index32)} x {index32.dim}, int8 {len(index14)} x "
          f"{index14.dim}, magnitudes in [0.5, 4]; per query one planted row equal to its "
          f"embedding and {PLANTED4} neighbours; query norms {norms.min():.3g}-{norms.max():.3g}",
          flush=True)
    kernels = {"fused_optimized_topk": fm.fused_optimized_topk,
               "fused_optimized_scores_int8": fm.fused_optimized_scores_int8_pallas,
               "fused_all_metrics": fm.fused_all_metrics,
               "fused_optimized_scores": fm.fused_optimized_scores}
    small = {}
    for key, ix in ((32, index32), (14, index14)):  # analysis-scale copies for scores()
        small[key] = ShardedVectorIndex(dim=ix.dim, config=IndexConfig(
            embedding_dim=ix.dim, dtype=ix.config.dtype, capacity_step=2048))
        at = np.arange(len(ix) - 2048, len(ix))
        small[key].insert([ix.paths[i] for i in at], ix.get_vectors(at), ix.get_magnitudes(at))

    # ---- the main path, counted ------------------------------------------
    for k in kernels.values():
        k.launches = 0
    # one mixed wave per tier: N_PLAIN6 requests under W_REF, the rest of the
    # queries under W_REF and FLT6, N_OTHER6 more under W_ALL, all enqueued
    # together so that a micro-batch holds several (metric, weights, filter)
    # groups
    wave = list(queries) + list(queries[:N_OTHER6])
    requests = ([dict(metric="optimized_similarity", weights=W_REF,
                      flt=None if i < N_PLAIN6 else FLT6) for i in range(len(queries))]
                + [dict(metric="optimized_similarity", weights=W_ALL)] * N_OTHER6)
    served, batches, groups = {}, {}, {}
    for key, enc, ix in ((14, enc14, index14), (32, enc32, index32)):
        server = SearchServer(enc, ix, max_batch=2 * len(wave), max_wait_ms=50.0)
        served[key], seconds, batches[key] = serve_wave(server, wave, requests)
        groups[key] = int(server.stats["groups"])
        print(f"weighted serving, {ix.config.dtype} tier: {len(wave)} concurrent text queries "
              f"(optimized_similarity: {N_PLAIN6} under {W_REF}, {len(queries) - N_PLAIN6} "
              f"under the same and {FLT6!r}, {N_OTHER6} under {W_ALL}) in {seconds:.3f} s = "
              f"{len(wave) / seconds:.1f} QPS over {len(ix)} x {ix.dim}, {batches[key]} "
              f"micro-batches of {groups[key]} groups (first calls included) [{card}]",
              flush=True)
        if groups[key] <= batches[key]:
            fail(f"{ix.config.dtype}: no micro-batch held two groups")
    multi = {(key, f): ix.multi_metric_topk(emb[key], TOP_K, flt=FLT6 if f else None)
             for key, ix in ((32, index32), (14, index14)) for f in (False, True)}
    l1 = index32.search(emb[32], TOP_K, "l1_distance")
    few = np.zeros(len(index32), bool)
    few[[first[32] + 1, 1000, 2000, len(index32) // 2]] = True
    l1_few = index32.search(emb[32][:4], TOP_K, "l1_distance", flt=few)
    scored = {key: small[key].scores(emb[key], "optimized_similarity", W_REF) for key in small}
    analysis = TextImageSearcher(enc32, index32).search_with_multiple_metrics(queries[0], top_k=5)
    # K4 and K7 serve no index tier (the f32 tiers' weighted score takes the
    # direct L2); their entry points are called as a user of ops/ would, over
    # the whole f32 gallery
    k4 = fm.fused_optimized_topk(qdev[32], index32._gallery, index32._mags, wtuple(W_REF), k=TOP_K)
    k7 = fm.fused_optimized_scores(qdev[32], index32._gallery, index32._mags,
                                   torch.tensor(wtuple(W_REF), device="cuda"))
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    # ---- end of the counted run ------------------------------------------
    blocks14 = -(-len(index14) // ROW_BLOCK)
    expected = {"fused_optimized_topk": 1, "fused_optimized_scores": 1,
                "fused_optimized_scores_int8": groups[14], "fused_all_metrics": 2 + 2 * blocks14}
    print(f"launches in the weighted main path: {launches} (expected: K5 one per micro-batch "
          f"group of the int8 tier = {groups[14]}; K6 one per f32 multi-metric call and one "
          f"per {ROW_BLOCK}-row block of the int8 tier = 2 + 2 x {blocks14}; K4 and K7 one "
          f"call each)", flush=True)
    if launches != expected:
        fail("the weighted path did not launch the metric kernels as expected")

    # ---- every answer against the float64 oracle -------------------------
    w = wtuple(W_REF)
    for key, ix in ((32, index32), (14, index14)):
        tier = ix.config.dtype
        best, full, full_sq = oracle_pass(torch, ix, qdev[key], w, TOP_K + 1)
        mags = torch.from_numpy(ix._host_mags[: len(ix)]).cuda().double()
        qn = torch.linalg.vector_norm(qdev[key].double(), dim=1, keepdim=True)

        def slack_of(b):
            return gram_slack(fm, torch.gather(full_sq, 1, b.i), mags[b.i], qn, ix.dim, w[2])

        gram = tier == "int8"  # the f32 tier's served score takes the direct L2
        vals, idx = answers_to_arrays(ix, served[key][: len(queries)])
        ov, oi = ix.search(emb[key][:N_OTHER6], TOP_K, "optimized_similarity", W_ALL)
        sv, si = answers_to_arrays(ix, served[key][len(queries):])
        if not (np.array_equal(si, oi) and np.allclose(sv, ov, rtol=0.0, atol=WEIGHTED_ATOL)):
            fail(f"{tier}: the requests under {W_ALL} did not get their own group's answers")
        print(f"{tier} tier: the {N_OTHER6} requests under the second weight set got the "
              f"index's answers for it (ids equal, scores within {WEIGHTED_ATOL})", flush=True)
        for f, rows in ((False, range(N_PLAIN6)), (True, range(N_PLAIN6, len(queries)))):
            b = best[("optimized_similarity", f)]
            part = slice(rows.start, rows.stop)
            worst, swaps = check_ranked(f"{tier} weighted{' filtered' if f else ''}",
                                        vals[part], idx[part], b, rows,
                                        slack_of(b) if gram else None)
            print(f"{tier} tier, optimized_similarity{' under ' + FLT6 if f else ''}: "
                  f"{len(rows)} served answers vs the float64 oracle: max score diff "
                  f"{worst:.3g} (limit {WEIGHTED_ATOL} + {WEIGHTED_RTOL} |score|), ids "
                  f"identical except {swaps} near-tie swaps", flush=True)
        own = sum(int(idx[i, 0] == first[key] + i) for i in range(N_PLAIN6))
        print(f"{tier} tier: {own} of {N_PLAIN6} unfiltered queries rank the row equal to "
              f"their embedding first", flush=True)
        if own != N_PLAIN6:
            fail(f"{tier}: a query did not find the row equal to its embedding")
        if not ix.filter_mask(FLT6)[idx[N_PLAIN6:]].all():
            fail(f"{tier}: a filtered answer left the filter")
        for f in (False, True):
            for name, (mv, mi) in multi[(key, f)].items():
                worst, swaps = check_ranked(f"{tier} multi-metric {name}", mv, mi, best[(name, f)])
                print(f"{tier} tier, multi_metric_topk {name}{' under ' + FLT6 if f else ''}: "
                      f"max score diff {worst:.3g}, {swaps} near-tie swaps", flush=True)
        if key == 32:
            worst, swaps = check_ranked("f32 l1_distance search", l1[0], l1[1],
                                        best[("l1_distance", False)])
            print(f"f32 tier, search(metric='l1_distance'), ascending: max score diff "
                  f"{worst:.3g}, {swaps} near-tie swaps", flush=True)
            fv, fi = l1_few
            if not ((fi[:, 4:] == -1).all() and np.isposinf(fv[:, 4:]).all()
                    and all(set(r[:4]) == set(np.flatnonzero(few)) for r in fi)
                    and (np.diff(fv[:, :4]) >= 0).all()):
                fail(f"f32 l1_distance under a 4-row filter: {fi} {fv}")
            print("f32 tier, l1_distance under a 4-row mask: the 4 rows ascending, then "
                  "(+inf, -1) padding", flush=True)
            # K4 and K7 over the whole gallery take the Gram-form L2: their
            # limit carries its slack (wide at the rows equal to a query)
            b = best[("optimized_similarity", False)]
            worst, swaps = check_ranked("K4 over the f32 gallery",
                                        k4[0].cpu().numpy().astype(np.float64),
                                        k4[1].cpu().numpy(), b, slack=slack_of(b))
            print(f"fused_optimized_topk over the whole f32 gallery, Q=64 k={TOP_K}: max score "
                  f"diff vs the float64 oracle {worst:.3g}, {swaps} near-tie swaps", flush=True)
            err = (k7.double() - full).abs()
            lim = (WEIGHTED_ATOL + WEIGHTED_RTOL * full.abs()
                   + gram_slack(fm, full_sq, mags[None, :], qn, ix.dim, w[2]))
            if not bool((err <= lim).all()):
                fail(f"fused_optimized_scores over the f32 gallery: worst error/limit "
                     f"{float((err / lim).max()):.3g}")
            print(f"fused_optimized_scores over the whole f32 gallery, Q=64: max diff vs the "
                  f"float64 oracle {float(err.max()):.3g} over {err.numel()} scores, worst "
                  f"error/limit {float((err / lim).max()):.3g}", flush=True)
            del err, lim
        # scores() of the analysis-scale copy (int8: the f32 scorer on the
        # dequantized rows, not the int8 fast path)
        sm = small[key]
        rows = torch.from_numpy(sm._host_gallery[: len(sm)]).cuda()
        if tier == "int8":
            rows = rows.float() * torch.from_numpy(sm._host_scales[: len(sm)]).cuda()[:, None]
        want = weighted_f64(f64_planes(
            torch, qdev[key].double(), rows.double(),
            torch.from_numpy(sm._host_mags[: len(sm)]).cuda().double()), w)
        err = (torch.from_numpy(scored[key]).cuda().double() - want).abs()
        print(f"{tier} tier, scores() over a {len(sm)}-row index: max diff vs float64 "
              f"{float(err.max()):.3g} (limit {WEIGHTED_ATOL} + {WEIGHTED_RTOL} |score|)",
              flush=True)
        if not bool((err <= WEIGHTED_ATOL + WEIGHTED_RTOL * want.abs()).all()):
            fail(f"{tier}: scores() disagrees with the float64 oracle")
        del best, full, full_sq, want, err, rows
        torch.cuda.empty_cache()
    cos5 = index32.search(emb[32][0] / np.linalg.norm(emb[32][0]), 5)[1]
    if ([h["path"] for h in analysis["cosine_similarity"]] != [index32.paths[i] for i in cos5]
            or set(analysis) != {"cosine_similarity", "l1_distance", "l2_distance",
                                 "linf_distance", "magnitude_difference",
                                 "optimized_similarity", "analysis"}
            or any(len(analysis[k]) != 5 for k in analysis if k != "analysis")):
        fail(f"search_with_multiple_metrics returned {analysis!r:.300}")
    print("search_with_multiple_metrics: six rankings of 5 with their analysis; the cosine "
          "ranking is the index's", flush=True)

    # ---- the kernels against their plain versions, then their times ------
    args = (index32._gallery, index32._mags, qdev[32], index14._gallery, index14._scales,
            index14._mags, qdev[14])
    worst = metric_kernels_vs_plain(torch, *args)
    times = time_metric_kernels(
        torch, card, *args,
        multimetric=lambda q: index14.multi_metric_topk(q.cpu().numpy(), TOP_K))
    from image_retrieval_tpu_torch.ops import _build

    print_metric_registers(_build.build())
    return launches, worst, times


# ---- phase 7: the encoder under the flags of the compute-dtype kernels --------

DENSE_KERNELS = ("layer_block", "attention_block", "mlp_block", "multihead_attention")


def dense_counts(fa, reset=False):
    if reset:
        for name in DENSE_KERNELS:
            getattr(fa, name).launches = 0
    return {name: getattr(fa, name).launches for name in DENSE_KERNELS}


def towers_vs_route(torch, enc, other, images, texts, what):
    """Embeddings of `enc` against those of `other` (the same weights under
    another routing) by row cosine, held to TOWER_MIN_COS."""
    ci = float(row_cos(torch.from_numpy(enc.encode_pixels(images)),
                       torch.from_numpy(other.encode_pixels(images))).min())
    ct = float(row_cos(torch.from_numpy(enc.encode_texts(texts)),
                       torch.from_numpy(other.encode_texts(texts))).min())
    print(f"{what}: min row cos image {ci:.6f} ({len(images)} images), text {ct:.6f} "
          f"({len(texts)} texts) (limit {TOWER_MIN_COS})", flush=True)
    if not (ci >= TOWER_MIN_COS and ct >= TOWER_MIN_COS):
        fail(f"{what}: the towers disagree")


def phase_dense(torch, card, queries, index14):
    """Phase 7: configuration A whole (ViT-B/32 under fused_layer_block, no
    int8: ingest, a 1M-row f32 index, served queries), then configurations B
    (ViT-L/14 under fused_layer_block) and C (ViT-B/32 under
    pallas_attention), each counted. Returns the launches of K8, K9a, K9b
    and K10 summed over the three counted runs."""
    import dataclasses

    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.config import Config, vit_b32, vit_l14
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.clip import DENSE_KERNEL, DENSE_LAYER, PLAIN
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    total = dict.fromkeys(DENSE_KERNELS, 0)

    def build(name, model, modes):
        t0 = time.perf_counter()
        enc = CLIPEncoder(Config(model=model), seed=0)  # no device=: the card
        got = (enc.model.vision.blocks[0].mode, enc.model.text.blocks[0].mode)
        if enc.device.type != "cuda" or got != modes:
            fail(f"{name}: on {enc.device}, towers routed {got}")
        print(f"CLIPEncoder {name} on {enc.device}: {model.vision_layers}+{model.text_layers} "
              f"layers, widths {model.vision_width}/{model.text_width}, compute dtype "
              f"{model.dtype}, routed {got}, {time.perf_counter() - t0:.1f} s to build",
              flush=True)
        return enc

    def counted(name, launches, expected, how):
        print(f"launches in the main path of {name}: {launches} (expected {how})", flush=True)
        if launches != expected:
            fail(f"{name}: the main path did not launch the kernels as expected: {expected}")
        for k, v in launches.items():
            total[k] += v

    # ---- configuration A: ViT-B/32, fused_layer_block, whole ----------------
    mc = dataclasses.replace(vit_b32(), fused_layer_block=True)
    cfg = Config(model=mc)
    enc = build("A = replace(vit_b32(), fused_layer_block=True)", mc,
                ((DENSE_LAYER, DENSE_LAYER), (DENSE_LAYER, DENSE_LAYER)))
    images = np.random.default_rng(0).integers(
        0, 256, size=(N_IMAGES, mc.image_size, mc.image_size, 3), dtype=np.uint8)
    enc.encode_pixels(images)  # warm-up (weight casts, cuBLAS handles): not counted
    enc.encode_texts(queries[:8])
    torch.cuda.synchronize()
    dense_counts(fa, reset=True)
    t0 = time.perf_counter()
    img_emb = enc.encode_pixels(images)
    embed_s = time.perf_counter() - t0
    index = ShardedVectorIndex(dim=mc.embed_dim, config=cfg.index)
    index.insert([f"images/{i:04d}.jpg" for i in range(N_IMAGES)], img_emb)
    grng = np.random.default_rng(1)  # the rows of phase 3
    rows = grng.standard_normal((N_ROWS, mc.embed_dim), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index.insert([f"gallery/{i:07d}" for i in range(N_ROWS)], rows)
    del rows
    server = SearchServer(enc, index, max_batch=64, max_wait_ms=2.0)
    answers, serve_s, batches = serve_wave(server, queries)
    launches = dense_counts(fa)
    image_chunks = -(-N_IMAGES // 256)
    counted("A", launches, dict.fromkeys(DENSE_KERNELS, 0) | {
        "layer_block": mc.vision_layers * image_chunks + mc.text_layers * batches},
            f"K8: {mc.vision_layers} x {image_chunks} image batch + {mc.text_layers} x {batches} "
            "text batches; no other kernel")
    print(f"A image embed throughput: {N_IMAGES / embed_s:.1f} img/s (one batch of {N_IMAGES}, "
          f"uint8 in, embeddings back on the host); server: {N_CLIENTS} concurrent clients "
          f"answered in {serve_s:.3f} s = {N_CLIENTS / serve_s:.1f} QPS over {len(index)} x "
          f"{mc.embed_dim} f32 rows, {batches} micro-batches [{card}]", flush=True)
    if img_emb.shape != (N_IMAGES, mc.embed_dim) or not np.isfinite(img_emb).all():
        fail(f"A: image embeddings {img_emb.shape} are not finite ({N_IMAGES}, {mc.embed_dim})")
    check_f32_answers(index, enc.encode_texts(queries), answers)
    del index, server
    towers_vs_plain(torch, enc, images[:8], queries[:8])
    plain32 = CLIPEncoder(Config(model=vit_b32()), seed=0)
    towers_vs_route(torch, enc, plain32, images[:64], queries,
                    "A through layer_block vs the plain route vit_b32() (bf16)")
    del enc
    torch.cuda.empty_cache()

    # ---- configuration C: ViT-B/32, pallas_attention -------------------------
    mc = dataclasses.replace(vit_b32(), pallas_attention=True)
    enc = build("C = replace(vit_b32(), pallas_attention=True)", mc,
                ((PLAIN, PLAIN), (PLAIN, PLAIN)))
    enc.encode_pixels(images[:8])
    torch.cuda.synchronize()
    dense_counts(fa, reset=True)
    img_emb = enc.encode_pixels(images)
    after_images = dense_counts(fa)
    enc.encode_texts(queries)
    launches = dense_counts(fa)
    counted("C", launches, dict.fromkeys(DENSE_KERNELS, 0) | {
        "multihead_attention": mc.vision_layers * image_chunks},
            f"K10: {mc.vision_layers} x {image_chunks} image batch, none in the text batch "
            "(its mask keeps the plain attention)")
    if after_images != launches or not np.isfinite(img_emb).all():
        fail("C: the text batch launched a kernel, or the embeddings are not finite")
    towers_vs_route(torch, enc, plain32, images[:64], queries,
                    "C through multihead_attention vs the plain route vit_b32() (bf16)")
    del enc, plain32
    torch.cuda.empty_cache()

    # ---- configuration B: ViT-L/14, fused_layer_block ------------------------
    mc = dataclasses.replace(vit_l14(), fused_layer_block=True)
    enc = build("B = replace(vit_l14(), fused_layer_block=True)", mc,
                ((DENSE_KERNEL, DENSE_KERNEL), (DENSE_LAYER, DENSE_LAYER)))
    images = np.random.default_rng(5).integers(
        0, 256, size=(N_IMAGES5, mc.image_size, mc.image_size, 3), dtype=np.uint8)
    enc.encode_pixels(images[:8])
    enc.encode_texts(queries[:8])
    torch.cuda.synchronize()
    index14.calls, index14.stage = [], "wave"
    dense_counts(fa, reset=True)
    t0 = time.perf_counter()
    img_emb = enc.encode_pixels(images)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    server = SearchServer(enc, index14, max_batch=64, max_wait_ms=2.0)
    wave = serve_wave(server, queries)
    launches = dense_counts(fa)
    counted("B", launches, dict.fromkeys(DENSE_KERNELS, 0) | {
        "attention_block": mc.vision_layers, "mlp_block": mc.vision_layers,
        "layer_block": mc.text_layers * wave[2]},
            f"{mc.vision_layers} K9a + {mc.vision_layers} K9b for the one image batch, "
            f"{mc.text_layers} K8 x {wave[2]} text batches")
    if img_emb.shape != (N_IMAGES5, mc.embed_dim) or not np.isfinite(img_emb).all():
        fail(f"B: image embeddings {img_emb.shape} are not finite")
    print(f"B image embed: {N_IMAGES5} images (one batch of {ENC_BUCKET5} with padding, "
          f"{ENC_BUCKET5 * 257} token rows) in {embed_s:.3f} s = {N_IMAGES5 / embed_s:.1f} img/s; "
          f"{N_CLIENTS} concurrent text queries over {len(index14)} x {index14.dim} int8 rows: "
          f"{N_CLIENTS / wave[1]:.1f} QPS ({wave[2]} micro-batches) [{card}]", flush=True)
    check_clients_got_the_indexs_answers("B", index14, [wave])
    worst, recall = check_answers(index14, int8_exact_oracle(torch, index14, 3 * TOP_K))
    for stage, (n, misses) in recall.items():
        print(f"B over the int8 tier, {stage}: recall@10 vs the oracle {1 - misses / n:.4f} "
              f"over {n} answers ({misses} misses; limit {RECALL_MIN}); max score diff "
              f"{worst:.3g} (limit {INT4_ORACLE_ATOL})", flush=True)
        if 1 - misses / n < RECALL_MIN:
            fail(f"B {stage}: recall@10 below {RECALL_MIN}")
    towers_vs_plain(torch, enc, images[:N_CHECK5], queries[:8])
    profile_encode(torch, enc, images, card, "B (L/14, fused_layer_block, bf16)")
    return total


# ---- phase 8: the trainer at full width ---------------------------------------

TRAIN_KERNELS = ("attention_block_train", *DENSE_KERNELS)


def train_batch(mc):
    """One seeded batch of N_PAIRS (pixels, tokens) pairs as train/data.py
    yields them: normalized f32 pixels, int32 ids with a start token, a
    caption of 4-20 ids, the end token (the largest id) and zero padding."""
    rng = np.random.default_rng(8)
    pixels = rng.standard_normal((N_PAIRS, mc.image_size, mc.image_size, 3), dtype=np.float32)
    tokens = np.zeros((N_PAIRS, mc.context_length), np.int32)
    for row in tokens:
        n = int(rng.integers(4, 21))
        row[0] = mc.vocab_size - 2
        row[1: 1 + n] = rng.integers(1, mc.vocab_size - 2, size=n)
        row[1 + n] = mc.vocab_size - 1
    return pixels, tokens


def profile_step(torch, tr, pixels, tokens, card, label):
    """One warm train step under torch.profiler: wall time, the device's busy
    time (the launches are serial on one stream) and its split by kernel
    family, the library's f32 products apart from the port's own kernels."""
    from torch.profiler import ProfilerActivity, profile

    families = (("DenseEpilogueBf16", "the port's bf16 GEMMs (wgmma)"),
                ("attention_tiled", "attention"),
                ("ln_cast", "LayerNorm passes"), ("sgemm", "library f32 GEMMs"),
                ("f32f32", "library f32 GEMMs"), ("multi_tensor_apply", "AdamW"),
                ("Memcpy", "copies"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(pixels, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms, other = {}, {}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or "#" in e.key:  # a "#" marks an annotation, no kernel
            continue
        family = next((fam for pat, fam in families if pat in e.key), "other kernels")
        ms[family] = ms.get(family, 0.0) + e.self_device_time_total / 1e3
        if family == "other kernels":
            other[e.key] = e.self_device_time_total / 1e3
    busy = sum(ms.values())
    if busy <= 0:
        print(f"{label} step profile: torch.profiler recorded no device time; device time "
              "by kernel not measured", flush=True)
        return
    parts = ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(ms.items(), key=lambda kv: -kv[1]))
    largest = "; ".join(f"{k[:60]} {v:.1f} ms"
                        for k, v in sorted(other.items(), key=lambda kv: -kv[1])[:4])
    print(f"{label} step profile at batch {N_PAIRS}, torch.profiler on: wall {wall_ms:.1f} ms, "
          f"device busy {busy:.1f} ms (idle share {max(0.0, 1 - busy / wall_ms):.1%}): {parts}; "
          f"the largest of the other kernels: {largest} [{card}]", flush=True)


def phase_train(torch, card):
    """Phase 8. Returns the launches of the compute-dtype kernels in the
    counted run (ten steps through fit, then one embedding pass without
    gradients) and the readings for the kernels line."""
    import dataclasses
    import itertools
    import math

    from image_retrieval_tpu_torch.config import vit_b32
    from image_retrieval_tpu_torch.models import clip as tclip
    from image_retrieval_tpu_torch.models.clip import DENSE_KERNEL, PLAIN
    from image_retrieval_tpu_torch.ops import flash_attention as fa
    from image_retrieval_tpu_torch.train import CLIPTrainer

    tcfg = dataclasses.replace(vit_b32(), fused_attn_block=True, fused_mlp_block=True,
                               fused_train_vjp=True)
    pixels, tokens = train_batch(tcfg)
    layers = tcfg.vision_layers + tcfg.text_layers

    def build(name, cfg, modes):
        t0 = time.perf_counter()
        tr = CLIPTrainer(cfg, seed=0)  # no device=: the card; the default learning rate
        got = (tr.model.vision.blocks[0].mode, tr.model.text.blocks[0].mode)
        if tr.device.type != "cuda" or got != modes or cfg.dtype != "bfloat16":
            fail(f"{name}: on {tr.device}, towers routed {got}, dtype {cfg.dtype}")
        n = sum(p.numel() for p in tr.model.parameters())
        print(f"CLIPTrainer {name} on {tr.device}: {cfg.vision_layers}+{cfg.text_layers} layers, "
              f"widths {cfg.vision_width}/{cfg.text_width}, {n / 1e6:.1f} M f32 parameters, "
              f"compute dtype {cfg.dtype}, routed {got}, AdamW lr "
              f"{tr.optimizer.param_groups[0]['lr']}, "
              f"{time.perf_counter() - t0:.1f} s to build", flush=True)
        return tr

    def run(tr):
        first = tr.train_step(pixels, tokens)  # warm (allocator, cuBLAS handles): not counted
        torch.cuda.synchronize()
        for k in TRAIN_KERNELS:
            getattr(fa, k).launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = tr.fit(itertools.repeat((pixels, tokens)), steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        return first, losses, (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS

    # ---- the main path, counted ------------------------------------------
    tk = build("replace(vit_b32(), fused_attn_block, fused_mlp_block, fused_train_vjp)", tcfg,
               ((DENSE_KERNEL, DENSE_KERNEL), (DENSE_KERNEL, DENSE_KERNEL)))
    first_k, losses_k, step_k = run(tk)
    peak_k = torch.cuda.max_memory_allocated() / 2 ** 30
    after_fit = {k: getattr(fa, k).launches for k in TRAIN_KERNELS}
    px, tok = tk._to_device(pixels, tokens)
    with torch.no_grad():
        emb_i, emb_t = tk.model.encode_image(px), tk.model.encode_text(tok)
    torch.cuda.synchronize()
    launches = {k: getattr(fa, k).launches for k in TRAIN_KERNELS}
    # ---- end of the counted run ------------------------------------------
    want_fit = dict.fromkeys(TRAIN_KERNELS, 0) | {
        "attention_block_train": layers * TRAIN_STEPS, "mlp_block": layers * TRAIN_STEPS}
    want = dict(want_fit) | {"attention_block": layers,
                             "mlp_block": layers * TRAIN_STEPS + layers}
    print(f"launches in the main path of phase 8: after {TRAIN_STEPS} steps {after_fit}, after "
          f"the embedding pass without gradients {launches} (expected {layers} K11 + {layers} "
          f"K9b a step, then {layers} K9a + {layers} K9b)", flush=True)
    if after_fit != want_fit or launches != want:
        fail("the trainer did not launch K11 and K9b once per layer per step")
    for name, e in (("image", emb_i), ("text", emb_t)):
        if e.shape != (N_PAIRS, tcfg.embed_dim) or not bool(torch.isfinite(e).all()):
            fail(f"phase 8: {name} embeddings {tuple(e.shape)} are not finite")

    tp = build("vit_b32() (the unfused route)", vit_b32(), ((PLAIN, PLAIN), (PLAIN, PLAIN)))
    first_p, losses_p, step_p = run(tp)
    peak_p = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(getattr(fa, k).launches for k in TRAIN_KERNELS):
        fail("the unfused route launched a kernel")
    profile_step(torch, tp, pixels, tokens, card, "unfused route")
    del tp
    torch.cuda.empty_cache()
    ln_b = math.log(N_PAIRS)
    curve_k, curve_p = [first_k] + losses_k, [first_p] + losses_p
    apart = [abs(a - b) for a, b in zip(curve_k, curve_p)]
    held = max(apart[:HELD_STEPS])
    print(f"phase 8 losses, {N_PAIRS} pairs repeated, through the kernels: "
          f"{' '.join(f'{v:.4f}' for v in curve_k)}", flush=True)
    print(f"phase 8 losses, the same steps through the unfused route: "
          f"{' '.join(f'{v:.4f}' for v in curve_p)}; ln {N_PAIRS} = {ln_b:.4f} (first loss within "
          f"{FIRST_LOSS_ATOL}); the first {HELD_STEPS} losses differ by at most {held:.4f} "
          f"(limit {TRAIN_LOSS_ATOL}), all {len(apart)} by at most {max(apart):.4f} (not held)",
          flush=True)
    if not all(math.isfinite(v) for v in curve_k + curve_p):
        fail("phase 8: a loss is not finite")
    if abs(first_k - ln_b) > FIRST_LOSS_ATOL or not curve_k[-1] < curve_k[0]:
        fail("phase 8: the first loss is not near ln(batch), or the loss did not fall")
    if held > TRAIN_LOSS_ATOL:
        fail("phase 8: the kernel route's losses left the unfused route's")
    upload = time_pair(torch, {"kernel": lambda: tk._to_device(pixels, tokens),
                               "plain": lambda: None}, samples=8, reps=1)["kernel"]
    print(f"phase 8 step time, {TRAIN_STEPS} steps through fit() at batch {N_PAIRS} (host clock, "
          f"numpy batches uploaded each step: {upload:.1f} ms of it): kernels {step_k:.1f} ms = "
          f"{N_PAIRS * 1e3 / step_k:.0f} pairs/s, peak {peak_k:.2f} GiB allocated; unfused "
          f"{step_p:.1f} ms = {N_PAIRS * 1e3 / step_p:.0f} pairs/s, peak {peak_p:.2f} GiB "
          f"[{card}]", flush=True)

    profile_step(torch, tk, pixels, tokens, card, "kernel route")

    # ---- one step's gradients: through the kernels vs the plain versions --
    def gradients():
        tk.optimizer.zero_grad(set_to_none=True)
        tk.loss(px, tok).backward()
        return {k: p.grad.clone() for k, p in tk.model.named_parameters()}

    through_kernels = gradients()
    kernels = tclip.attention_block_train, tclip.mlp_block
    # the plain versions on the card: autograd through
    # attention_block_reference and mlp_block_reference
    tclip.attention_block_train = fa.attention_block_reference
    tclip.mlp_block = fa.mlp_block_reference
    try:
        before = {k: getattr(fa, k).launches for k in TRAIN_KERNELS}
        through_plain = gradients()
        if before != {k: getattr(fa, k).launches for k in TRAIN_KERNELS}:
            fail("the plain step launched a kernel")
    finally:
        tclip.attention_block_train, tclip.mlp_block = kernels
    cos = {k: float(row_cos(g.reshape(1, -1), through_plain[k].reshape(1, -1)))
           for k, g in through_kernels.items() if not k.endswith("k_proj.bias")}
    low = min(cos, key=cos.get)
    print(f"phase 8 gradients of one step, kernels vs plain versions on the card: "
          f"{len(cos)} parameters, min cosine {cos[low]:.6f} at {low} (limit {GRAD_MIN_COS}; "
          f"the {layers} key biases, whose gradient is zero in exact arithmetic, left out)",
          flush=True)
    if not cos[low] >= GRAD_MIN_COS:
        fail("phase 8: a gradient through the kernels left the plain versions'")
    del tk, through_kernels, through_plain, px, tok
    torch.cuda.empty_cache()
    backward = time_train_backward(torch, card)
    return launches, {"step_ms": step_k, "plain_step_ms": step_p, "backward": backward}


# ---------------------------------------------------------------------------
# Phase 9: the durable ingest-and-serve slice.

# Seeded JPEGs in three subfolders (the `dir` attribute), those the live
# ingest adds and removes, the served queries, the gallery-scale checkpoint's
# added rows, the idle-share window's batches.
N_JPEG9, JPEG_SIZE9, SUBDIRS9 = 4096, (640, 480), ("a", "b", "c")
N_ADD9, N_REMOVE9, N_TEXT9, N_IMAGE9 = 512, 256, 64, 16
N_CKPT_ADD9 = 65_536
IDLE_BATCHES9, IDLE_BATCH9 = 8, 128
DURABLE_FIXTURE = os.path.join("tests", "data", "jax_journal_int8")


def write_jpegs(folder, first, n, seed):
    """n seeded 640 x 480 JPEGs, image i in subfolder SUBDIRS9[i % 3]: a
    smooth field (a 20 x 15 seeded grid, bilinear), so each file is a few
    tens of KB. Returns the paths in index order."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def one(i):
        rng = np.random.default_rng((seed, i))
        small = Image.fromarray(rng.integers(0, 256, (15, 20, 3), dtype=np.uint8))
        path = os.path.join(folder, SUBDIRS9[i % 3], f"img{i:05d}.jpg")
        small.resize(JPEG_SIZE9, Image.Resampling.BILINEAR).save(path, quality=90)
        return path

    for sub in SUBDIRS9:
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(first, first + n)))


def encoder_chunks(n, buckets=(8, 32, 128, 192, 256)):
    """Forwards CLIPEncoder runs for a batch of n rows (its bucket ladder)."""
    step = next((b for b in buckets if min(n, buckets[-1]) <= b), n)
    return -(-n // step) if n else 0


def live_oracle(index, q, k, exclude=None):
    """float64 cosine of queries q (Q, D) against the live rows of `index`:
    per query the best k + 1 as (scores, paths), lowest row first among
    ties, the path `exclude[i]` (an image query's own) dropped."""
    live = np.flatnonzero(index.live_mask())
    q = np.asarray(q, np.float64)
    qn = np.linalg.norm(q, axis=1, keepdims=True)
    s = np.empty((q.shape[0], len(live)), np.float64)
    step = 1 << 17
    for lo in range(0, len(live), step):
        s[:, lo: lo + step] = q @ index.get_vectors(live[lo: lo + step]).astype(np.float64).T
    s /= np.where(qn > 0, qn, 1.0)
    out = []
    for i, row in enumerate(s):
        cand = np.flatnonzero(row >= np.partition(row, -(k + 2))[-(k + 2)])
        order = cand[np.lexsort((cand, -row[cand]))]
        keep = [j for j in order
                if exclude is None or index.paths[live[j]] != exclude[i]][: k + 1]
        out.append((row[keep], [index.paths[live[j]] for j in keep]))
    return out


def check_path_answers(what, answers, oracle, k=TOP_K, others=None):
    """Served [{'path', 'score'}] answers against live_oracle's (scores,
    paths): k hits each, scores within ORACLE_SCORE_ATOL, paths identical
    except where the oracle's neighbours lie within that; `others` (answers
    of another run of the same queries) held to the same rule. Returns
    (worst score difference, near-tie swaps)."""
    worst, swaps = 0.0, 0
    for i, (ans, (ov, op)) in enumerate(zip(answers, oracle)):
        if len(ans) != k:
            fail(f"{what} query {i}: {len(ans)} hits, expected {k}")
        for name, got in (("served", ans), ("other", None if others is None else others[i])):
            if got is None:
                continue
            sv = np.array([h["score"] for h in got], np.float64)
            diff = np.abs(sv - ov[:k])
            worst = max(worst, float(diff.max()))
            if (diff > ORACLE_SCORE_ATOL).any():
                fail(f"{what} query {i} ({name}): scores {sv} vs oracle {ov[:k]}")
            for r, h in enumerate(got):
                if h["path"] != op[r]:
                    gaps = [abs(ov[r] - ov[o]) for o in (r - 1, r + 1) if 0 <= o < len(ov)]
                    if min(gaps) > ORACLE_SCORE_ATOL:
                        fail(f"{what} query {i} ({name}) rank {r}: {h['path']} != oracle "
                             f"{op[r]} with gaps {gaps}")
                    swaps += 1
    return worst, swaps


def durable_child(journal_dir, incoming, gallery_json, out_path):
    """Phase 9's crashing server (run as `chip_smoke.py --durable-child`):
    open the journal, ingest the incoming images and remove N_REMOVE9 paths
    through SearchServer while 64 text and 16 image queries are served, then
    answer the same queries again, write everything down and SIGKILL
    itself, with no checkpoint."""
    import signal

    import torch

    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.config import Config, vit_b32_serving
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with open(gallery_json) as f:
        spec = json.load(f)
    enc = CLIPEncoder(Config(model=vit_b32_serving()), seed=0)
    index = ShardedVectorIndex.open(journal_dir)
    print(f"child: reopened {journal_dir} ({len(index)} rows) and built the encoder in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    adds = sorted(os.path.join(incoming, sub, f) for sub in SUBDIRS9
                  for f in os.listdir(os.path.join(incoming, sub)))
    removes = spec["remove_gallery"] + adds[: N_REMOVE9 - len(spec["remove_gallery"])]
    texts, images = spec["texts"], spec["images"]
    errors, acks = [], {}
    server = SearchServer(enc, index, max_batch=64, max_wait_ms=2.0)
    server.start()
    enc.encode_texts(texts[:8])  # the int8 weights, before the clock starts

    def client(key, call):
        try:
            hits = call()
            if len(hits) != TOP_K:
                errors.append(f"{key}: {len(hits)} hits during the ingest")
        except Exception as e:  # reported below
            errors.append(f"{key}: {e!r}")

    def ingest():
        try:
            acks["inserted"] = server.add_images(adds)
            acks["removed"] = server.remove_images(removes)
        except Exception as e:
            errors.append(f"ingest: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=ingest)]
    threads += [threading.Thread(target=client, args=(("text", i), lambda i=i: server.search(
        texts[i], top_k=TOP_K, timeout=300))) for i in range(len(texts))]
    threads += [threading.Thread(target=client, args=(("image", i), lambda i=i: server.search_similar(
        images[i], top_k=TOP_K, timeout=300))) for i in range(len(images))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    ingest_s = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        print(f"child: failed: {errors[:3]}", flush=True)
        os._exit(3)
    final_text = server.search_many(texts, top_k=TOP_K, timeout=300)
    final_image = [server.search_similar(p, top_k=TOP_K, timeout=300) for p in images]
    server.stop()
    out = {"inserted": adds, "removed": removes, "acks": acks, "final_text": final_text, "final_image": final_image,
           "text_emb": enc.encode_texts(texts).tolist(),
           "image_emb": enc.encode_images(images).tolist()}
    with open(out_path + ".tmp", "w") as f:
        json.dump(out, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(out_path + ".tmp", out_path)
    print(f"child: acknowledged {acks} in {ingest_s:.2f} s with {len(texts)} text and "
          f"{len(images)} image queries served meanwhile; killing itself", flush=True)
    os.kill(os.getpid(), signal.SIGKILL)


def idle_share(torch, enc, batches, window, card):
    """encode_stream over `batches` with the window set to `window`, under
    torch.profiler: wall time, and the device's busy time as the union of
    its kernel and copy intervals. Prints and returns the idle share."""
    from torch.profiler import ProfilerActivity, profile

    enc._MAX_IN_FLIGHT = window
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in enc.encode_stream(iter(batches)):
                pass
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        del enc._MAX_IN_FLIGHT
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start)
    if not spans:
        print(f"idle share, window {window}: torch.profiler recorded no device time; "
              "not measured", flush=True)
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    share = max(0.0, 1.0 - busy / wall_us)
    print(f"idle share, L/14 int8 encode_stream of {len(batches)} x {len(batches[0][1])} "
          f"uint8 images, window {window}: wall {wall_us / 1e3:.1f} ms, device busy "
          f"(kernels and copies, union) {busy / 1e3:.1f} ms, idle {share:.1%} "
          f"(torch.profiler on) [{card}]", flush=True)
    return share


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def work_root(prefix="chip_smoke_durable_"):
    """A new directory under TMPDIR, or under the checkout when TMPDIR has
    less than 10 GB free (phase 9's gallery-scale checkpoint peaks near 6 GB,
    phase 11's IVF save near 7 GB)."""
    import shutil
    import tempfile

    tmp = tempfile.gettempdir()
    free = {tmp: shutil.disk_usage(tmp).free, ".": shutil.disk_usage(".").free}
    root = tmp if free[tmp] >= 10e9 or free[tmp] >= free["."] else "."
    print(f"work directory under {os.path.abspath(root)} "
          f"({free[root] / 1e9:.1f} GB free)", flush=True)
    return tempfile.mkdtemp(prefix=prefix, dir=root)


def run_cli_in(cwd, argv):
    """cli.main(argv) from `cwd`, its standard output captured; a non-zero
    exit fails the phase. The CLI's INFO logging is turned back down."""
    import contextlib
    import io
    import logging

    from image_retrieval_tpu_torch.app import cli

    os.makedirs(cwd, exist_ok=True)
    out = io.StringIO()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    logging.getLogger().setLevel(logging.WARNING)
    if rc != 0:
        fail(f"cli {' '.join(argv)} exited {rc}")
    return out.getvalue()


def phase_durable(torch, card, enc, enc14, index32, queries):
    """Phase 9 (see the module docstring). Returns the K1 and K6 launches of
    its counted runs."""
    import shutil

    from image_retrieval_tpu_torch.app import webui
    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.config import IndexConfig
    from concurrent.futures import ThreadPoolExecutor

    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.preprocess import preprocess_host
    from image_retrieval_tpu_torch.ops import flash_attention as fa
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    t_phase = time.perf_counter()
    work = work_root()
    try:
        gallery, incoming = os.path.join(work, "gallery"), os.path.join(work, "incoming")
        journal = os.path.join(work, "journal")
        t0 = time.perf_counter()
        # the order ImageSearchApp.scan_folders ingests them in
        paths = sorted(write_jpegs(gallery, 0, N_JPEG9, 9))
        write_jpegs(incoming, N_JPEG9, N_ADD9, 9)
        print(f"phase 9: wrote {N_JPEG9} + {N_ADD9} seeded {JPEG_SIZE9[0]} x {JPEG_SIZE9[1]} "
              f"JPEGs ({dir_bytes(gallery) / 1e6:.1f} MB + {dir_bytes(incoming) / 1e6:.1f} MB) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)

        # ---- the CLI: ingest + a text query, counted --------------------
        def run_cli(argv):
            return run_cli_in(work, argv)

        fa.layer_block_int8.launches = 0
        t0 = time.perf_counter()
        printed = run_cli(["search", "--folder", gallery, "--fast_encoder",
                           "--journal_dir", journal, queries[0]])
        cli_s = time.perf_counter() - t0
        k1 = fa.layer_block_int8.launches
        # ---- end of the counted CLI run ---------------------------------
        bs = 100  # Config.batch_size, the loader's batch
        image_chunks = sum(encoder_chunks(min(bs, N_JPEG9 - i)) for i in range(0, N_JPEG9, bs))
        expected = 12 * image_chunks + 12
        print(f"cli search --fast_encoder over {N_JPEG9} JPEGs: {cli_s:.1f} s "
              f"({N_JPEG9 / cli_s:.1f} img/s with the decode, one loader thread); "
              f"layer_block_int8 launches {k1} (expected 12 x {image_chunks} image batches "
              f"+ 12 x 1 text batch = {expected}) [{card}]", flush=True)
        if k1 != expected:
            fail("the CLI's ingest did not run layer_block_int8 12 times per batch")
        hits = [line for line in printed.splitlines() if line.strip()[:1].isdigit()]
        if len(hits) != TOP_K:
            fail(f"cli search printed {len(hits)} hits: {printed[-500:]}")

        # the in-flight embeddings against the same encoder with a window of 1
        cached = np.load(os.path.join(work, "new_embeddings.npz"),
                         allow_pickle=True)["embeddings"].item()
        # the loader's pixels (preprocess_host, as its PIL path decodes),
        # decoded on 8 threads, in the loader's batches
        with ThreadPoolExecutor(8) as pool:
            pixels = np.stack(list(pool.map(lambda p: preprocess_host(p, 224), paths)))
        enc._MAX_IN_FLIGHT = 1
        try:
            feed = ((paths[i: i + bs], pixels[i: i + bs]) for i in range(0, N_JPEG9, bs))
            sync = {p: e for ps, embs in enc.encode_stream(feed) for p, e in zip(ps, embs)}
        finally:
            del enc._MAX_IN_FLIGHT
        del pixels
        if list(cached) != paths:
            fail(f"the CLI ingested {len(cached)} paths in another order: {list(cached)[:3]}")
        differ = [p for p in paths if not np.array_equal(cached[p], sync[p])]
        if differ:
            worst = max(float(np.abs(cached[p] - sync[p]).max()) for p in differ)
            fail(f"in-flight embeddings differ from the window-of-1 embeddings: "
                 f"{len(differ)} of {len(paths)} rows, max abs {worst:.3g}")
        print(f"in-flight embeddings of the CLI's ingest equal the window-of-1 run's bit for "
              f"bit ({N_JPEG9} x {len(sync[paths[0]])})", flush=True)

        # ---- compare: K6 through search_with_multiple_metrics, counted --
        recorded = []
        real_mm = ShardedVectorIndex.multi_metric_topk

        def recording_mm(self, q, *a, **kw):
            out = real_mm(self, q, *a, **kw)
            recorded.append((np.array(q, np.float32, ndmin=2), self, out))
            return out

        ShardedVectorIndex.multi_metric_topk = recording_mm
        fa.layer_block_int8.launches = fm.fused_all_metrics.launches = 0
        try:
            run_cli(["compare", "--folder", gallery, "--fast_encoder", "--journal_dir",
                     journal, queries[1], "--top-k", str(TOP_K)])
        finally:
            ShardedVectorIndex.multi_metric_topk = real_mm
        k6, k1_compare = fm.fused_all_metrics.launches, fa.layer_block_int8.launches
        # ---- end of the counted compare run ------------------------------
        print(f"cli compare: fused_all_metrics launches {k6} (expected 1 per call, "
              f"{len(recorded)} call), layer_block_int8 {k1_compare} (12 x 1 text batch; "
              "the rows came back from the journal)", flush=True)
        if len(recorded) != 1 or k6 != 1 or k1_compare != 12:
            fail("compare did not run K6 once and K1 once per layer")
        q, ix, mm = recorded[0]
        qd = torch.from_numpy(q).cuda().double()
        rows = torch.from_numpy(ix.get_vectors(np.arange(len(ix)))).cuda().double()
        mags = torch.from_numpy(ix.get_magnitudes(np.arange(len(ix)))).cuda().double()
        planes = f64_planes(torch, qd, rows, mags)
        for name, (vals, idx) in mm.items():
            best = Best(torch, 1, TOP_K + 1, name == "cosine_similarity")
            best.add(planes[name], 0)
            worst, swaps = check_ranked(f"compare {name}", np.atleast_2d(vals),
                                        np.atleast_2d(idx), best)
            print(f"compare {name}: vs float64 oracle max diff {worst:.3g}, "
                  f"{swaps} near-tie swaps", flush=True)
        # the compare app's index holds the journal open: drop it before
        # another process writes the directory
        recorded.clear()
        del q, ix, mm, rows, mags, planes

        # ---- a server crashes under load ---------------------------------
        texts = queries[:N_TEXT9]
        images = [p for i, p in enumerate(paths) if i % 97 == 5][:N_IMAGE9]
        remove_gallery = [p for i, p in enumerate(paths)
                          if i % 31 == 7 and p not in images][: N_REMOVE9 // 2]
        spec = os.path.join(work, "child.json")
        with open(spec, "w") as f:
            json.dump({"texts": texts, "images": images, "remove_gallery": remove_gallery}, f)
        out_path = os.path.join(work, "child_answers.json")
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--durable-child",
                                journal, incoming, spec, out_path],
                               capture_output=True, text=True, timeout=600)
        print(child.stdout.rstrip(), flush=True)
        if child.returncode != -9 or not os.path.exists(out_path):
            fail(f"the child exited {child.returncode}, not by SIGKILL: {child.stderr[-2000:]}")
        print(f"child killed by SIGKILL after {time.perf_counter() - t0:.1f} s", flush=True)
        with open(out_path) as f:
            done = json.load(f)
        if done["acks"] != {"inserted": [N_ADD9, 0], "removed": N_REMOVE9}:
            fail(f"the child's acknowledgements: {done['acks']}")

        # ---- reopen ---------------------------------------------------------
        t0 = time.perf_counter()
        ix = ShardedVectorIndex.open(journal)
        reopen_s = time.perf_counter() - t0
        alive = {p for p, a in zip(ix.paths, ix.live_mask()) if a}
        lost = [p for p in done["inserted"] if p not in alive and p not in done["removed"]]
        back = [p for p in done["removed"] if p in alive]
        print(f"reopened after the crash in {reopen_s:.2f} s: {len(ix)} rows, {ix.live_count} "
              f"live; acknowledged inserts missing {len(lost)}, acknowledged deletes back "
              f"{len(back)}", flush=True)
        if lost or back or len(ix) != N_JPEG9 + N_ADD9 or ix.live_count != \
                N_JPEG9 + N_ADD9 - N_REMOVE9:
            fail("the reopened index lost an acknowledged insert or delete")
        text_emb = np.asarray(done["text_emb"], np.float32)
        image_emb = np.asarray(done["image_emb"], np.float32)
        server = SearchServer(enc, ix, max_batch=64, max_wait_ms=2.0)
        server.start()
        try:
            got_text = server.search_many(texts, top_k=TOP_K, timeout=300)
            got_image = [server.search_similar(p, top_k=TOP_K, timeout=300) for p in images]
            for what, got, child_ans, emb, excl in (
                    ("text", got_text, done["final_text"], text_emb, None),
                    ("image", got_image, done["final_image"], image_emb, images)):
                worst, swaps = check_path_answers(f"after the crash, {what}", got,
                                                  live_oracle(ix, emb, TOP_K, excl),
                                                  others=child_ans)
                if excl is not None and any(p in [h["path"] for h in a]
                                            for p, a in zip(excl, got + child_ans)):
                    fail("an image query's own path was not excluded")
                print(f"after the crash: {len(got)} {what} answers vs the child's last answers "
                      f"and the float64 oracle: max score diff {worst:.3g} (limit "
                      f"{ORACLE_SCORE_ATOL}), {swaps} near-tie swaps", flush=True)

            # ---- the web UI over the reopened index ------------------------
            httpd = webui.serve(server, ix.paths, port=0)
            th = threading.Thread(target=httpd.serve_forever, daemon=True)
            th.start()
            try:
                import urllib.parse
                import urllib.request

                base = f"http://127.0.0.1:{httpd.server_address[1]}"
                web = [json.loads(urllib.request.urlopen(base + tail, timeout=120).read())
                       for tail in (f"/search?q={urllib.parse.quote(texts[0])}&k={TOP_K}",
                                    f"/similar?path={urllib.parse.quote(images[0])}&k={TOP_K}")]
            finally:
                httpd.shutdown()
                httpd.server_close()
            for (what, a), b in zip((("search", web[0]), ("similar", web[1])),
                                    (server.search(texts[0], top_k=TOP_K),
                                     server.search_similar(images[0], top_k=TOP_K))):
                if [h["path"] for h in a] != [h["path"] for h in b] or not np.allclose(
                        [h["score"] for h in a], [h["score"] for h in b], rtol=0, atol=1e-6):
                    fail(f"web UI /{what} differs from the server's answer")
            print("web UI: /search and /similar over HTTP equal the server's answers", flush=True)
        finally:
            server.stop()
        del ix, server

        # ---- a journal directory written by the JAX package --------------
        jax_dir = os.path.join(work, "jax_journal")
        shutil.copytree(DURABLE_FIXTURE, jax_dir)
        with open(os.path.join(jax_dir, "expected.json")) as f:
            exp = json.load(f)
        jx = ShardedVectorIndex.open(jax_dir)
        if (len(jx), jx.live_count, jx.paths, jx.meta) != (exp["count"], exp["live"],
                                                          exp["paths"], exp["meta"]):
            fail("the JAX-written journal reopened with other rows or meta")
        qf = np.asarray(exp["queries"], np.float32)
        for key, flt in (("unfiltered", None), ("filtered", exp["filter"])):
            vals, ids = jx.search(qf, top_k=TOP_K, flt=flt)
            if not (np.array_equal(ids, exp[key]["ids"]) and np.allclose(
                    vals, exp[key]["scores"], rtol=0, atol=ORACLE_SCORE_ATOL)):
                fail(f"the JAX-written journal answers differently ({key})")
        print(f"{DURABLE_FIXTURE} (written by the JAX package: int8 tier, a snapshot and a "
              f"log to replay) reopened on the card: {len(jx)} rows, the JAX index's answers "
              "(ids identical, scores within 1e-5)", flush=True)
        del jx

        # ---- checkpoint at gallery scale ----------------------------------
        n3 = N_IMAGES + N_ROWS
        big = os.path.join(work, "big")
        rows3 = index32._host_gallery[:n3]
        mags3 = index32._host_mags[:n3]
        paths3 = index32.paths[:n3]
        ix = ShardedVectorIndex.open(big, config=IndexConfig(embedding_dim=rows3.shape[1]))
        t0 = time.perf_counter()
        ix.insert(paths3, rows3, mags3)
        ix.flush()
        insert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ix.checkpoint()
        ckpt_s = time.perf_counter() - t0
        extra = np.random.default_rng(19).standard_normal((N_CKPT_ADD9, rows3.shape[1]),
                                                          dtype=np.float32)
        extra /= np.linalg.norm(extra, axis=1, keepdims=True)
        ix.insert([f"late/{i:05d}" for i in range(N_CKPT_ADD9)], extra)
        ix.flush()
        journal_bytes = dir_bytes(big)
        del ix
        t0 = time.perf_counter()
        ix = ShardedVectorIndex.open(big)
        open_s = time.perf_counter() - t0
        q64 = enc.encode_texts(queries)
        oracle = live_oracle(ix, q64, TOP_K)

        def held(index, what):
            if len(index) != n3 + N_CKPT_ADD9 or index.live_count != n3 + N_CKPT_ADD9:
                fail(f"{what}: {len(index)} rows, expected {n3 + N_CKPT_ADD9}")
            vals, ids = index.search(q64 / np.linalg.norm(q64, axis=1, keepdims=True),
                                     top_k=TOP_K)
            ans = [[{"path": index.paths[j], "score": float(v)} for v, j in zip(vr, ir)]
                   for vr, ir in zip(vals, ids)]
            return check_path_answers(what, ans, oracle)

        w_open = held(ix, "checkpoint + log, reopened")
        saved = os.path.join(work, "saved", "gallery")
        t0 = time.perf_counter()
        ix.save(saved)
        save_s = time.perf_counter() - t0
        save_bytes = sum(os.path.getsize(os.path.join(work, "saved", f))
                         for f in os.listdir(os.path.join(work, "saved")))
        del ix
        t0 = time.perf_counter()
        lx = ShardedVectorIndex.load_from(saved)
        load_s = time.perf_counter() - t0
        w_load = held(lx, "save -> load_from")
        del lx
        print(f"gallery-scale durability, {n3:,} x {rows3.shape[1]} f32 rows (phase 3's) + "
              f"{N_CKPT_ADD9:,}: insert + flush {insert_s:.2f} s, checkpoint {ckpt_s:.2f} s, "
              f"journal directory {journal_bytes / 1e9:.3f} GB, open (snapshot + log replay) "
              f"{open_s:.2f} s, save {save_s:.2f} s ({save_bytes / 1e9:.3f} GB), load_from "
              f"{load_s:.2f} s (warm page cache); 64 queries vs the float64 oracle: max diff "
              f"{max(w_open[0], w_load[0]):.3g}, near-tie swaps {w_open[1]} / {w_load[1]} "
              f"[{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- the device's idle share over L/14 image batches, window 4 and 1 ----
    size = enc14.config.model.image_size
    rng = np.random.default_rng(23)
    batches = [(i, rng.integers(0, 256, size=(IDLE_BATCH9, size, size, 3), dtype=np.uint8))
               for i in range(IDLE_BATCHES9)]
    for _ in enc14.encode_stream(iter(batches[:1])):
        pass
    for window in (4, 1):
        idle_share(torch, enc14, batches, window, card)
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k1 + k1_compare, k6


def phase_durable_alone(torch, card):
    """--durable: phase 9 on what phases 3 and 5 would hand it: the B/32
    serving encoder and its 1,000,256-row f32 gallery (256 encoded seeded
    images and N_ROWS seeded unit rows, as phase 3 builds them) and the L/14
    int8 serving encoder, all from seed 0."""
    from image_retrieval_tpu_torch.config import (Config, IndexConfig, serving_config,
                                                  vit_b32_serving, vit_l14)
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    enc = CLIPEncoder(Config(model=vit_b32_serving()), seed=0)
    enc14 = CLIPEncoder(Config(model=serving_config(vit_l14()),
                               index=IndexConfig(embedding_dim=768, dtype="int8")), seed=0)
    words_a = ["red", "blue", "green", "small", "old", "shiny", "dark", "wet"]
    words_b = ["car", "dog", "house", "tree", "boat", "cat", "bridge", "clock"]
    queries = [f"a photo of a {a} {b}" for a in words_a for b in words_b][:N_CLIENTS]
    images = np.random.default_rng(0).integers(0, 256, size=(N_IMAGES, 224, 224, 3),
                                               dtype=np.uint8)
    index32 = ShardedVectorIndex(dim=512)
    index32.insert([f"images/{i:04d}.jpg" for i in range(N_IMAGES)], enc.encode_pixels(images))
    grng = np.random.default_rng(1)
    rows = grng.standard_normal((N_ROWS, 512), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index32.insert([f"gallery/{i:07d}" for i in range(N_ROWS)], rows,
                   grng.uniform(0.5, 4.0, N_ROWS).astype(np.float32))
    del rows
    return phase_durable(torch, card, enc, enc14, index32, queries)


# ---- phase 10: the tiers beyond the resident sweep ---------------------------

# The streamed gallery: rows (8 GiB of int8 at D = 512), rows a generated
# piece (quantized on the host a piece at a time: the f32 gallery never
# exists whole), single queries per stage, tombstones (blocks of 8 rows, so
# that a compact keeps every row's bucket = row % 8 for the oracle).
N10, PIECE10, SINGLES10, DELETES10 = 1 << 24, 1 << 22, 4, 4096
FLT10 = "bucket == 3"
STREAM_ATOL = 1e-6  # streamed vs resident int8 tier over the same rows on the card
# recall@10 of the screen against the exact tier: the floor of the JAX
# package's tests/test_screen.py::test_recall_on_clustered_data
SCREEN_RECALL_MIN = 0.9
SCREEN_DIMS, SCREEN_POOL = 128, 128


def mem_available_gib() -> float:
    """MemAvailable of /proc/meminfo, GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / (1 << 20)
    return float("nan")


def agree_topk(what, got, want, atol):
    """(scores, ids) against (scores, ids) of the same queries: scores
    within atol, ids equal except where neighbouring wanted scores lie
    within atol (a tie either side may order). Returns (worst, swaps)."""
    gv, gi = (np.atleast_2d(a) for a in got)
    wv, wi = (np.atleast_2d(a) for a in want)
    if gv.shape != wv.shape:
        fail(f"{what}: shapes {gv.shape} and {wv.shape}")
    fin = np.isfinite(wv)
    if not np.array_equal(np.isfinite(gv), fin) or not np.array_equal(gi[~fin], wi[~fin]):
        fail(f"{what}: the padding differs")
    worst = float(np.abs(gv[fin] - wv[fin]).max()) if fin.any() else 0.0
    if worst > atol:
        fail(f"{what}: scores differ by {worst:.3g} (limit {atol})")
    swaps = 0
    for r, c in zip(*np.nonzero(gi != wi)):
        gaps = [abs(wv[r, c] - wv[r, o]) for o in (c - 1, c + 1) if 0 <= o < wv.shape[1]]
        if min(gaps) > atol:
            fail(f"{what}: query {r} rank {c}: id {gi[r, c]} != {wi[r, c]}, gaps {gaps}")
        swaps += 1
    return worst, swaps


def recall_at10(got_ids, exact_ids) -> float:
    got, exact = np.atleast_2d(got_ids), np.atleast_2d(exact_ids)
    return float(np.mean([len(set(g[:TOP_K].tolist()) & set(e[:TOP_K].tolist())) / TOP_K
                          for g, e in zip(got, exact)]))


def host_ms(fn, times):
    """Median host-clock ms of `times` calls of fn (each ends with its
    answers on the host)."""
    got = []
    for _ in range(times):
        t0 = time.perf_counter()
        fn()
        got.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(got))


def tiers_on_phase5(torch, card, enc14, index14, queries):
    """Approximate selection, the l1_shadow gallery and the resident screen
    over phase 5's int8 gallery (with phase 6's planted rows), and
    SearchServer(ann=screen). Returns the readings."""
    import dataclasses

    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.index.screen import ScreenedSearch
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops.metrics import (
        fused_optimized_scores_int8_shadow,
        make_l1_shadow,
    )

    out = {}
    cfg = index14.config
    emb = enc14.encode_texts(queries)  # unnormalized: the weighted score's query
    qn = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    qdev = torch.from_numpy(emb).cuda()
    index14.stage = "phase 10"

    # approximate selection: the exact selector's answers, bit for bit
    index14.config = dataclasses.replace(cfg, approx_select=True)
    for metric, params in (("cosine_similarity", None), ("optimized_similarity", W_REF)):
        q = qn if params is None else emb
        for got, want in ((index14.search(q, TOP_K, metric, params),
                           index14.search(q, TOP_K, metric, params, approx=False)),
                          (index14.search(q[0], TOP_K, metric, params),
                           index14.search(q[0], TOP_K, metric, params, approx=False))):
            if not (np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])):
                fail(f"approx_select=True: {metric} answers differ from the exact selector's")
    index14.config = cfg
    print(f"approx_select=True over phase 5's {len(index14)} x {index14.dim} int8 rows: "
          f"cosine and optimized answers (64 queries and a single one) bit for bit the "
          f"exact selector's", flush=True)

    # l1_shadow=True: accepted, no bf16 copy built, the weighted answers
    # through K5 against the int8 scorer's float64 oracle by phase 6's
    # limits; the shadow scorer the option once ran (tensor operations over
    # a bf16 copy, ops/metrics.py) timed beside K5 on the same rows
    w = wtuple(W_REF)
    index14.config = dataclasses.replace(cfg, l1_shadow=True)
    index14._device_dirty = True
    index14.load()
    torch.cuda.synchronize()
    k5 = fm.fused_optimized_scores_int8_pallas
    k5_before = k5.launches
    vals, idx = index14.search(emb, TOP_K, "optimized_similarity", W_REF)
    k5_launches = k5.launches - k5_before
    if k5_launches < 1 or hasattr(index14, "_shadow"):
        fail(f"l1_shadow=True: the weighted search ran {k5_launches} K5 launches")
    best, full, full_sq = oracle_pass(torch, index14, qdev, w, TOP_K + 1)
    del full
    mags = torch.from_numpy(index14._host_mags[: len(index14)]).cuda().double()
    qnd = torch.linalg.vector_norm(qdev.double(), dim=1, keepdim=True)
    b = best[("optimized_similarity", False)]
    slack = gram_slack(fm, torch.gather(full_sq, 1, b.i), mags[b.i], qnd, index14.dim, w[2])
    worst, swaps = check_ranked("l1_shadow weighted", vals, idx, b, slack=slack)
    del best, full_sq, slack
    index14.config = cfg
    g, sc, m = index14._gallery, index14._scales, index14._mags
    sh = make_l1_shadow(g, sc, m)
    shadow_gib = sh.numel() * 2 / 2**30
    times = {}
    for nq in (1, 64):
        q = qdev[:nq].contiguous()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fused_optimized_scores_int8_shadow(q, g, sc, m, sh, w)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        times[nq] = {
            "shadow_ms": event_ms(torch, lambda: fused_optimized_scores_int8_shadow(
                q, g, sc, m, sh, w), samples=3, reps=1, warm=1),
            "k5_ms": event_ms(torch, lambda: k5(q, g, sc, m, w), samples=5, reps=2,
                              warm=1),
            "shadow_peak_gib": peak}
    rows_gib = g.numel() / 2**30
    del g, sc, m, sh
    print(f"l1_shadow=True over the same rows: no shadow built, the weighted search "
          f"through K5 ({k5_launches} launch(es)); answers (weights {W_REF}, 64 queries) "
          f"vs the int8 scorer's float64 oracle: max score diff {worst:.3g}, {swaps} "
          f"near-tie swaps. The shadow scorer the option would run: {shadow_gib:.3f} GiB "
          f"of bf16 rows beside {rows_gib:.3f} GiB of int8 rows, Q=64 "
          f"{times[64]['shadow_ms']:.3f} ms, peak +{times[64]['shadow_peak_gib']:.3f} GiB; "
          f"K5 {times[64]['k5_ms']:.4f} ms; Q=1 shadow {times[1]['shadow_ms']:.3f} ms, "
          f"peak +{times[1]['shadow_peak_gib']:.3f} GiB, K5 {times[1]['k5_ms']:.4f} ms "
          f"[{card}]", flush=True)
    out["shadow"] = dict(times, shadow_gib=shadow_gib, worst=worst)
    torch.cuda.empty_cache()

    # the projection screen over the resident int8 gallery
    t0 = time.perf_counter()
    scr = ScreenedSearch.from_index(index14, sketch_dims=SCREEN_DIMS, candidates=SCREEN_POOL)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sv, si = scr.search(qn, TOP_K)
    ev, ei = index14.search(qn, TOP_K)
    rec = recall_at10(si, ei)
    p50_1 = host_ms(lambda: scr.search(qn[3], TOP_K), 20)
    p50_64 = host_ms(lambda: scr.search(qn, TOP_K), 5)
    exact_1 = host_ms(lambda: index14.search(qn[3], TOP_K), 20)
    exact_64 = host_ms(lambda: index14.search(qn, TOP_K), 5)
    print(f"screen over phase 5's {len(index14)} x {index14.dim} int8 rows (pca, "
          f"{SCREEN_DIMS} dims, {SCREEN_POOL} candidates): built in {build_s:.2f} s; "
          f"recall@10 vs the exact tier {rec:.4f} over {len(qn)} queries (limit "
          f"{SCREEN_RECALL_MIN}); p50 single query {p50_1:.3f} ms, 64 queries "
          f"{p50_64:.3f} ms; the exact tier {exact_1:.3f} / {exact_64:.3f} ms (host clock) "
          f"[{card}]", flush=True)
    if rec < SCREEN_RECALL_MIN:
        fail(f"the screen's recall@10 {rec:.4f} is below {SCREEN_RECALL_MIN}")
    out["screen"] = dict(build_s=build_s, recall=rec, p50_1=p50_1, p50_64=p50_64,
                         exact_1=exact_1, exact_64=exact_64)

    # a pool that covers every row: the exact tier's answers
    sub = np.arange(1 << 16)
    small = ShardedVectorIndex(dim=index14.dim, config=IndexConfig(
        embedding_dim=index14.dim, dtype="int8", capacity_step=1 << 16))
    small.insert([index14.paths[i] for i in sub], index14.get_vectors(sub),
                 index14.get_magnitudes(sub))
    full = ScreenedSearch.from_index(small, sketch_dims=SCREEN_DIMS, candidates=len(small))
    worst, swaps = agree_topk("screen, full pool", full.search(qn[:8], TOP_K),
                              small.search(qn[:8], TOP_K), STREAM_ATOL)
    print(f"screen with a pool of every row ({len(small)} rows, 8 queries): the exact "
          f"tier's answers, scores within {worst:.3g}, {swaps} near-tie swaps", flush=True)
    del small, full

    # SearchServer(ann=screen): the clients get what the screen answered
    class RecordingScreen:
        def __init__(self, inner):
            self.inner, self.calls = inner, []

        def search(self, q, top_k):
            got = self.inner.search(q, top_k)
            self.calls.append((np.array(q, np.float32, ndmin=2), top_k, got))
            return got

    rscr = RecordingScreen(scr)
    server = SearchServer(enc14, index14, max_batch=64, max_wait_ms=2.0, ann=rscr)
    answers, seconds, batches = serve_wave(server, queries)
    seen = set()
    for _, _, (v, i) in rscr.calls:
        for vr, ir in zip(np.atleast_2d(v), np.atleast_2d(i)):
            seen.add(tuple((index14.paths[j], float(x)) for x, j in zip(vr, ir) if j >= 0)[:TOP_K])
    for a in answers:
        if tuple((h["path"], h["score"]) for h in a) not in seen:
            fail("SearchServer(ann=screen): a client's answer is not the screen's")
    # the micro-batches' queries as one search() through the screen
    qs = np.concatenate([q for q, _, _ in rscr.calls])
    k = rscr.calls[0][1]
    want = scr.search(qs, k)
    got = tuple(np.concatenate([np.atleast_2d(a[j]) for _, _, a in rscr.calls])
                for j in (0, 1))
    worst, swaps = agree_topk("SearchServer(ann=screen) vs one search()", got, want,
                              STREAM_ATOL)
    # an insert detaches the screen (it cannot follow it); the exact sweep serves
    from PIL import Image

    img = os.path.join(work_root(), "inserted.jpg")
    Image.fromarray(np.random.default_rng(10).integers(0, 256, (480, 640, 3),
                                                       dtype=np.uint8)).save(img)
    ok, _ = server.add_images([img])
    if ok != 1 or server.ann is not None:
        fail("SearchServer(ann=screen) kept the screen after an insert")
    after, _, _ = serve_wave(server, queries[:4])
    exact_after = index14.search(qn[:4], TOP_K)
    if [[h["path"] for h in a] for a in after] != [[index14.paths[j] for j in r]
                                                    for r in exact_after[1]]:
        fail("after the detach the server did not serve the exact tier's answers")
    # leave phase 5's gallery as the later phases expect it: the insert out
    n_before = len(index14) - 1
    index14.delete([img])
    index14.compact()
    if len(index14) != n_before:
        fail(f"phase 5's gallery holds {len(index14)} rows after phase 10, not {n_before}")
    print(f"SearchServer(ann=screen): {len(queries)} concurrent text queries in "
          f"{seconds:.3f} s = {len(queries) / seconds:.1f} QPS, {batches} micro-batches; "
          f"every answer what the screen returned for its micro-batch, and the same "
          f"queries as one search() within {worst:.3g} ({swaps} near-tie swaps); an insert detached the screen "
          f"and 4 more queries got the exact tier's answers [{card}]", flush=True)
    out["screen"]["server_qps"] = len(queries) / seconds
    del scr, rscr, server
    torch.cuda.empty_cache()
    return out


def streamed_timings(torch, card, name, ix, qbatch):
    """The streamed sweep of `ix` timed: a 64-query batch and single
    queries (host clock), one chunk's upload from pinned host rows (CUDA
    events: the host->device rate), one chunk's sweep with the chunk on the
    card (CUDA events), and expected_sweep_seconds from those two."""
    from image_retrieval_tpu_torch.ops.int4 import unit_queries

    eng = ix._stream
    q = torch.from_numpy(qbatch).cuda()
    batch_ms = host_ms(lambda: ix.search(qbatch, TOP_K), 3)
    single_ms = host_ms(lambda: ix.search(qbatch[5], TOP_K), 5)
    host = torch.from_numpy(eng._rows[: eng.chunk_rows])
    buf = torch.empty(host.shape, dtype=host.dtype, device="cuda")
    copy_ms = event_ms(torch, lambda: buf.copy_(host, non_blocking=True), samples=3, reps=1,
                       warm=1)
    gbps = host.numel() / (copy_ms / 1e3) / 1e9
    out = {"batch_ms": batch_ms, "single_ms": single_ms, "h2d_gbps": gbps}
    for nq in (64, 1):
        q16 = unit_queries(q[:nq]).to(torch.bfloat16).contiguous()
        kk = min(max(eng.rerank_c, TOP_K), eng.n) if eng.packed4 else TOP_K
        ms = event_ms(torch, lambda: eng._chunk_topk(q16, q16.float(), buf, 0, buf.shape[0],
                                                     None, kk), samples=3, reps=1, warm=1)
        out[f"chunk_ms_q{nq}"] = ms
        out[f"expected_s_q{nq}"] = eng.expected_sweep_seconds(gbps, ms / 1e3)
    print(f"{name} streamed over {eng.n} rows ({len(eng._chunks)} chunks of {eng.chunk_rows} "
          f"rows, {eng.bytes_per_sweep / 2**30:.2f} GiB a sweep): 64 queries {batch_ms:.1f} ms, "
          f"single query p50 {single_ms:.1f} ms (host clock); one chunk's upload from pinned "
          f"host rows {copy_ms:.2f} ms = {gbps:.2f} GB/s; one chunk's sweep on the card Q=64 "
          f"{out['chunk_ms_q64']:.2f} ms, Q=1 {out['chunk_ms_q1']:.2f} ms; "
          f"expected_sweep_seconds {out['expected_s_q64'] * 1e3:.1f} ms (Q=64) / "
          f"{out['expected_s_q1'] * 1e3:.1f} ms (Q=1) beside the sweeps above [{card}]",
          flush=True)
    del buf
    return out


def phase_tiers(torch, card, enc14, index14, queries, q_emb):
    """Phase 10: the tiers beyond the resident sweep. Returns (K3 launches
    of the streamed main path, readings)."""
    import dataclasses

    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.index.screen import ScreenedSearch
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    t_phase = time.perf_counter()
    print(f"phase 10: MemAvailable {mem_available_gib():.1f} GiB", flush=True)
    out = tiers_on_phase5(torch, card, enc14, index14, queries)

    # ---- the streamed gallery: 2^24 rows, int8 and int4 -------------------
    d = q_emb.shape[1]
    qbatch = q_emb / np.linalg.norm(q_emb, axis=1, keepdims=True)
    pos, planted = planted_rows(q_emb, np.random.default_rng(10), N10)
    cfg8 = IndexConfig(embedding_dim=d, dtype="int8", capacity_step=N10,
                       stream_threshold_bytes=N10 * d // 2)
    cfg4 = IndexConfig(embedding_dim=d, dtype="int4", capacity_step=N10, rerank_c=RERANK_C,
                       stream_threshold_bytes=N10 * d // 4)
    Index = recording_index(ShardedVectorIndex)
    ix8, ix4 = Index(dim=d, config=cfg8), Index(dim=d, config=cfg4)
    t0 = time.perf_counter()
    for c in range(N10 // PIECE10):
        rows = gallery_chunk(torch, c, d, pos, planted, n=PIECE10, seed=2000)
        ids = np.arange(c * PIECE10, (c + 1) * PIECE10)
        paths = [f"stream/{i:08d}" for i in ids]
        for ix in (ix8, ix4):
            ix.insert(paths, rows, np.ones(PIECE10, np.float32), attrs={"bucket": ids % 8})
        del rows, paths
    insert_s = time.perf_counter() - t0
    print(f"streamed galleries: {N10} x {d} seeded unit rows ({PLANTED4} planted per query) "
          f"quantized on the host in pieces of {PIECE10} into an int8 index "
          f"({ix8._host_gallery.nbytes / 2**30:.1f} GiB of pinned int8 rows, threshold "
          f"{cfg8.stream_threshold_bytes / 2**30:.1f} GiB) and an int4 index "
          f"({ix4._host_packed.nbytes / 2**30:.1f} GiB of pinned packed rows, threshold "
          f"{cfg4.stream_threshold_bytes / 2**30:.1f} GiB) in {insert_s:.1f} s; "
          f"MemAvailable {mem_available_gib():.1f} GiB", flush=True)
    asks = [(qbatch, None), (qbatch, FLT10)] + [
        (qbatch[j], f) for j in range(SINGLES10) for f in (None, FLT10)]

    def run(ix, stage):
        ix.stage = stage
        return [ix.search(q, top_k=TOP_K, flt=f) for q, f in asks]

    # the resident int8 tier over the same rows on the card, for comparison
    ix8.config = dataclasses.replace(cfg8, stream_threshold_bytes=None)
    ix8._device_dirty = True
    resident = run(ix8, "resident")
    ix8.calls = []
    ix8.config, ix8._device_dirty = cfg8, True
    torch.cuda.empty_cache()

    # ---- the main path, counted ------------------------------------------
    k3.int4_screen_scores.launches = 0
    expected, took, checks = 0, {}, []
    # tombstones: the 8-row blocks of two queries' planted rows, then seeded
    # blocks up to DELETES10 rows
    mine = np.unique(pos[:2 * PLANTED4] // 8)
    more = np.random.default_rng(11).choice(N10 // 8, DELETES10 // 8 + len(mine), replace=False)
    blocks = np.concatenate([mine, more[~np.isin(more, mine)]])[: DELETES10 // 8]
    dead = (blocks[:, None] * 8 + np.arange(8)).ravel()
    for stage in ("initial", "deleted", "compacted"):
        for ix in (ix8, ix4):
            if stage == "deleted":
                ix.delete_rows(dead)
            elif stage == "compacted":
                ix.compact()
        for name, ix in (("int8", ix8), ("int4", ix4)):
            t0 = time.perf_counter()
            answers = run(ix, stage)
            took[(name, stage)] = time.perf_counter() - t0
            if ix._stream is None:
                fail(f"{name}: the index left the streamed tier at {stage}")
            if name == "int4":
                expected += len(asks) * sum(-(-nv // k3.SEGMENT_ROWS)
                                            for _, nv in ix._stream._chunks)
            if stage == "initial" and name == "int8":
                for (q, f), got, want in zip(asks, answers, resident):
                    checks.append(agree_topk(f"streamed vs resident int8 ({f})", got, want,
                                             STREAM_ATOL))
            worst, recall = check_answers(ix, int8_exact_oracle(torch, ix, 3 * TOP_K))
            for st, (n, misses) in recall.items():
                if 1 - misses / n < RECALL_MIN:
                    fail(f"streamed {name} {st}: recall@10 {1 - misses / n:.4f}")
            print(f"streamed {name}, {stage} ({ix.live_count} live rows): {len(asks)} "
                  f"searches (64 queries and {SINGLES10} single ones, unfiltered and under "
                  f"{FLT10!r}) in {took[(name, stage)]:.2f} s; vs the float64 int8-exact "
                  f"oracle max score diff {worst:.3g} (limit {INT4_ORACLE_ATOL}), recall@10 "
                  f"{1 - misses / n:.4f}", flush=True)
            ix.calls = []
    launches = k3.int4_screen_scores.launches
    # ---- end of the counted run ------------------------------------------
    worst = max(w for w, _ in checks)
    print(f"streamed int8 vs the resident int8 tier over the same rows on the card: "
          f"{len(checks)} answers, max score diff {worst:.3g} (limit {STREAM_ATOL}), "
          f"{sum(s for _, s in checks)} near-tie swaps", flush=True)
    print(f"int4_screen launches in the streamed main path: {launches} (expected {expected}: "
          f"one per {k3.SEGMENT_ROWS}-row segment of each packed chunk, per search)",
          flush=True)
    if launches != expected:
        fail("the streamed int4 tier did not screen every chunk segment through K3")

    # K3 on one streamed chunk's segment against its plain version
    eng4 = ix4._stream
    seg = torch.from_numpy(eng4._rows[: k3.SEGMENT_ROWS]).cuda()
    valid = torch.ones(seg.shape[0], dtype=torch.bool, device="cuda")
    qu64 = torch.from_numpy(qbatch).cuda().to(torch.bfloat16)
    out["k3_chunk"] = screen_vs_plain(torch, card, seg, eng4._scales[: seg.shape[0]], valid,
                                      qu64, counts=(64,))
    del seg, valid

    out["int8"] = streamed_timings(torch, card, "int8", ix8, qbatch)
    out["int4"] = streamed_timings(torch, card, "int4", ix4, qbatch)
    del ix4
    torch.cuda.empty_cache()

    # the streamed screen over the streamed int8 index
    t0 = time.perf_counter()
    scr = ScreenedSearch.from_index(ix8, sketch_dims=SCREEN_DIMS, candidates=SCREEN_POOL)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not scr.streamed:
        fail("the screen over the streamed index did not take its streamed mode")
    ix8.stage = "screen"
    rec = recall_at10(scr.search(qbatch, TOP_K)[1], ix8.search(qbatch, TOP_K)[1])
    p50_1 = host_ms(lambda: scr.search(qbatch[3], TOP_K), 20)
    p50_64 = host_ms(lambda: scr.search(qbatch, TOP_K), 5)
    print(f"streamed screen over {ix8.live_count} x {d} int8 rows (pca, {SCREEN_DIMS} dims, "
          f"{SCREEN_POOL} candidates; sketch {scr._sketch.numel() / 2**30:.2f} GiB on the "
          f"card): built in {build_s:.2f} s (two passes over the host rows); recall@10 vs the "
          f"streamed exact tier {rec:.4f} (limit {SCREEN_RECALL_MIN}); p50 single query "
          f"{p50_1:.3f} ms, 64 queries {p50_64:.3f} ms (host clock) [{card}]", flush=True)
    if rec < SCREEN_RECALL_MIN:
        fail(f"the streamed screen's recall@10 {rec:.4f} is below {SCREEN_RECALL_MIN}")
    out["streamed_screen"] = dict(build_s=build_s, recall=rec, p50_1=p50_1, p50_64=p50_64)
    ix8._drop_stream()
    del scr, ix8
    torch.cuda.empty_cache()
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s; MemAvailable "
          f"{mem_available_gib():.1f} GiB", flush=True)
    return launches, out


def phase_tiers_alone(torch, card):
    """--tiers: phase 10 on what phases 3, 5 and 6 would hand it: the B/32
    serving encoder's text embeddings, the L/14 int8 serving encoder and a
    2^20-row int8 gallery with phase 5's and phase 6's planted rows."""
    from image_retrieval_tpu_torch.config import (Config, IndexConfig, serving_config,
                                                  vit_b32_serving, vit_l14)
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    words_a = ["red", "blue", "green", "small", "old", "shiny", "dark", "wet"]
    words_b = ["car", "dog", "house", "tree", "boat", "cat", "bridge", "clock"]
    queries = [f"a photo of a {a} {b}" for a in words_a for b in words_b][:N_CLIENTS]
    q_emb = CLIPEncoder(Config(model=vit_b32_serving()), seed=0).encode_texts(queries)
    enc14 = CLIPEncoder(Config(model=serving_config(vit_l14()),
                               index=IndexConfig(embedding_dim=768, dtype="int8")), seed=0)
    emb14 = enc14.encode_texts(queries)
    index14 = recording_index(ShardedVectorIndex)(dim=768, config=IndexConfig(
        embedding_dim=768, dtype="int8", capacity_step=N5 + 65536))
    pos, planted = planted_rows(emb14, np.random.default_rng(6), N5)
    index14.insert([f"gallery/{i:07d}" for i in range(N5)],
                   gallery_chunk(torch, 0, 768, pos, planted),
                   np.random.default_rng(7).uniform(0.5, 4.0, N5).astype(np.float32),
                   attrs={"bucket": np.arange(N5) % 8})
    plant_rows(torch, index14, emb14, 62)
    return phase_tiers(torch, card, enc14, index14, queries, q_emb)


# Phase 11: IVF over phase 3's f32 gallery (the reference's IVF_FLAT
# deployment: nlist 1024, nprobe 10), its recall floor where the exact
# top-10 are planted rows; 2^23 clustered rows (4,096 planted clusters) at
# recommended_ivf's operating point; single-query samples; the planner's
# constants held within PLAN_TOLERANCE of index/plan.py's.
NLIST11, NPROBE11, IVF_ATOL11, IVF_RECALL_MIN11 = 1024, 10, 1e-5, 0.9
N11, CLUSTERS11, TRAIN11, PIECE11 = 1 << 23, 4096, 512 << 10, 1 << 20
N_ADD11, N_REMOVE11, SINGLES11 = 256, 256, 4
PLAN_TOLERANCE = 0.25
PLAN_ROWS11 = (1 << 20, 1 << 23, 1 << 25, 1 << 27)
IVF_FIXTURE = os.path.join("tests", "data", "jax_ivf_int8.npz")
IVF_FIXTURE_ANSWERS = os.path.join("tests", "data", "jax_ivf_int8_answers.npz")


def ivf_clusters(ivf, n_rows):
    """Row id -> its cluster (the slab it lies in), -1 for rows not packed."""
    rid = ivf._row_ids.cpu().numpy()
    cl = np.full(n_rows, -1, np.int64)
    slots = np.flatnonzero(rid >= 0)
    cl[rid[slots]] = slots // ivf._lmax
    return cl


def ivf_probes(torch, ivf, q, nprobe):
    """The top-nprobe clusters of each query (lowest id first among ties)."""
    from image_retrieval_tpu_torch.ops.int4 import unit_queries
    from image_retrieval_tpu_torch.ops.topk import exact_topk

    with torch.inference_mode():
        qu = unit_queries(torch.from_numpy(np.atleast_2d(q).astype(np.float32)).cuda())
        return exact_topk(qu @ ivf._centroids.t(), nprobe)[1].cpu().numpy()


def check_ivf_hits(what, index, ivf, q_emb, hits, nprobe):
    """Every (score, path) of hits[i] (served for query q_emb[i]) against
    the float64 cosine of that row (IVF_ATOL11) and inside one of the
    query's probed clusters or the IVF's tail. Returns (worst diff, ids
    (Q, TOP_K), -1 pad)."""
    import torch

    path_id = {p: i for i, p in enumerate(index.paths)}
    cl = ivf_clusters(ivf, len(index))
    probes = ivf_probes(torch, ivf, q_emb, nprobe)
    worst, ids = 0.0, np.full((len(hits), TOP_K), -1, np.int64)
    for i, ans in enumerate(hits):
        if not ans:
            fail(f"{what}: query {i} got no hits")
        got = np.array([path_id[h["path"]] for h in ans])
        ids[i, : len(got)] = got[:TOP_K]
        q = q_emb[i].astype(np.float64)
        cos = index.get_vectors(got).astype(np.float64) @ (q / np.linalg.norm(q))
        worst = max(worst, float(np.abs(cos - np.array([h["score"] for h in ans])).max()))
        tail = got >= ivf.count - ivf.tail_count  # rows added since the build
        outside = [int(j) for j, t in zip(got, tail) if not t and cl[j] not in probes[i]]
        if outside:
            fail(f"{what}: query {i} returned rows outside its {nprobe} probed clusters "
                 f"and the tail: {outside[:5]}")
    if worst > IVF_ATOL11:
        fail(f"{what}: scores differ from the float64 cosine by {worst:.3g} "
             f"(limit {IVF_ATOL11})")
    return worst, ids


def clustered_gallery(torch, n, d, clusters, seed):
    """n seeded unit rows around `clusters` seeded unit centres (cosine to
    the centre uniform in [0.4, 0.8]), made on the card in PIECE11-row
    pieces and copied to the host. Returns (rows f32 (n, d), centres (C, d)
    on the card, cluster of each row)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.nn.functional.normalize(
        torch.randn(clusters, d, device="cuda", generator=g), dim=1)
    member = torch.randint(0, clusters, (n,), device="cuda", generator=g)
    rows = np.empty((n, d), np.float32)
    for lo in range(0, n, PIECE11):
        hi = min(lo + PIECE11, n)
        torch.from_numpy(rows[lo:hi]).copy_(clustered_points(torch, centres, member[lo:hi], g))
    return rows, centres, member.cpu().numpy()


def clustered_points(torch, centres, member, g):
    """Unit points at cosine U[0.4, 0.8] to their centres."""
    d = centres.shape[1]
    rho = torch.rand(len(member), 1, device="cuda", generator=g) * 0.4 + 0.4
    noise = torch.randn(len(member), d, device="cuda", generator=g)
    sigma = torch.sqrt((1.0 / rho ** 2 - 1.0) / d)
    return torch.nn.functional.normalize(centres[member] + sigma * noise, dim=1)


def offload_breakdown(torch, ivf, q):
    """Where an offloaded search of the batch q goes (medians of 3, host
    clock, each part ending synchronized): the probes on the card, the host
    gather of the unique probed slabs into pinned memory on one thread,
    their upload. Returns (parts, unique slabs)."""
    from image_retrieval_tpu_torch.ops.int4 import unit_queries
    from image_retrieval_tpu_torch.ops.topk import exact_topk

    lmax, row = ivf._lmax, ivf._host_packed.shape[1]
    qu = unit_queries(torch.from_numpy(q).cuda())
    probe = [None]

    def probes():
        probe[0] = exact_topk(qu @ ivf._centroids.t(), ivf.nprobe)[1].cpu().numpy()

    probe_ms = host_ms(probes, 3)
    uniq = np.unique(probe[0])
    staging = torch.empty((len(uniq), lmax * row), dtype=torch.int8, pin_memory=True)
    gather_ms = host_ms(lambda: np.take(ivf._host_packed.reshape(-1, lmax * row), uniq, axis=0,
                                        out=staging.numpy(), mode="clip"), 3)

    def upload():
        staging.to("cuda", non_blocking=True)
        torch.cuda.synchronize()

    return {"probe": probe_ms, "gather": gather_ms, "upload": host_ms(upload, 3)}, len(uniq)


def ivf_reference_deployment(torch, card, enc, index32, queries, q_emb):
    """Phase 11 A: IVF_FLAT nlist 1024 / nprobe 10 over phase 3's f32 gallery
    with phase 6's planted rows; the server and the searcher through it;
    inserts and removals through the server. Returns (K1 launches, readings)."""
    from image_retrieval_tpu_torch.app.search import TextImageSearcher
    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.index.ivf import IVFIndex
    from image_retrieval_tpu_torch.ops import flash_attention as fa

    out = {}
    t0 = time.perf_counter()
    ivf = IVFIndex.from_index(index32, nlist=NLIST11, nprobe=NPROBE11)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    parts = ", ".join(f"{k} {v:.2f} s" for k, v in ivf.build_seconds.items())
    print(f"IVF_FLAT over {index32.live_count} x {index32.dim} f32 rows: nlist {ivf.nlist}, "
          f"nprobe {ivf.nprobe}, lmax {ivf._lmax} ({ivf._packed.numel() * 4 / 2**30:.2f} GiB "
          f"of slabs on the card), built by IVFIndex.from_index in {out['build_s']:.2f} s "
          f"({parts}) [{card}]", flush=True)

    text_layers = enc.config.model.text_layers
    server = SearchServer(enc, index32, max_batch=64, max_wait_ms=2.0, ann=ivf)
    fa.layer_block_int8.launches = 0
    answers, serve_s, batches = serve_wave(server, queries)
    k1 = fa.layer_block_int8.launches
    if k1 != text_layers * batches:
        fail(f"the IVF server's text batches ran {k1} K1 launches, expected "
             f"{text_layers} x {batches}")
    worst, got = check_ivf_hits("SearchServer(ann=ivf)", index32, ivf, q_emb, answers, NPROBE11)
    searcher = TextImageSearcher(enc, index32, ann=ivf)
    singles = [searcher.search(queries[i], top_k=TOP_K, score_threshold=-1.0)
               for i in range(SINGLES11)]
    worst1, got1 = check_ivf_hits("TextImageSearcher(ann=ivf)", index32, ivf,
                                  q_emb[:SINGLES11], singles, NPROBE11)
    if not np.array_equal(got1, got[:SINGLES11]):
        fail("the searcher's IVF answers differ from the server's")
    qn = q_emb / np.linalg.norm(q_emb, axis=1, keepdims=True)
    exact = index32.search(qn, TOP_K)[1]
    planted = np.array([all(index32.paths[j].startswith(("self/", "near/")) for j in row)
                        for row in exact])
    rec = recall_at10(got[planted], exact[planted]) if planted.any() else float("nan")
    out.update(recall=rec, planted_queries=int(planted.sum()))
    ivf_1 = host_ms(lambda: ivf.search(qn[0], TOP_K), 20)
    ivf_64 = host_ms(lambda: ivf.search(qn, TOP_K), 5)
    ex_1 = host_ms(lambda: index32.search(qn[0], TOP_K), 20)
    ex_64 = host_ms(lambda: index32.search(qn, TOP_K), 5)
    out.update(p50_1=ivf_1, p50_64=ivf_64, exact_p50_1=ex_1, exact_p50_64=ex_64,
               serve_s=serve_s)
    print(f"SearchServer(ann=ivf): {N_CLIENTS} concurrent text queries in {serve_s:.3f} s "
          f"({batches} micro-batches, {k1} K1 launches); TextImageSearcher(ann=ivf) "
          f"{SINGLES11} single ones, the same answers; every (score, id) vs the float64 "
          f"cosine of its row max diff {max(worst, worst1):.3g} (limit {IVF_ATOL11}), every "
          f"id in one of its query's {NPROBE11} probed clusters; recall@10 vs the exact f32 "
          f"tier over the {int(planted.sum())} queries whose exact top-10 are planted rows "
          f"{rec:.4f} (limit {IVF_RECALL_MIN11}); p50 (host clock) one query IVF {ivf_1:.3f} "
          f"ms vs exact {ex_1:.3f} ms, 64 queries IVF {ivf_64:.3f} ms vs exact {ex_64:.3f} ms "
          f"[{card}]", flush=True)
    if planted.sum() < N_CLIENTS // 2 or not rec >= IVF_RECALL_MIN11:
        fail(f"IVF recall@10 {rec:.4f} over {int(planted.sum())} planted queries")

    # live inserts and removals through the server: the IVF stays attached
    import shutil
    import tempfile

    folder = tempfile.mkdtemp(prefix="chip_smoke_ivf_")
    try:
        paths = write_jpegs(folder, 0, N_ADD11, seed=1111)
        first = len(index32)
        fa.layer_block_int8.launches = 0
        ok, failed = server.add_images(paths)
        if ok != N_ADD11 or failed or server.ann is not ivf or ivf.tail_count != N_ADD11:
            fail(f"add_images: {ok} inserted, {failed} failed, IVF attached "
                 f"{server.ann is ivf}, tail {ivf.tail_count}")
        server.start()
        try:
            found = [server.search_similar(p, top_k=TOP_K, exclude_self=False, timeout=300)
                     for p in paths[:16]]
        finally:
            server.stop()
        for p, hits in zip(paths, found):
            if hits[0]["path"] != p or hits[0]["score"] < 0.999:
                fail(f"an inserted image is not its own best hit through the IVF tail: "
                     f"{p} -> {hits[0]}")
        # the answers' best non-self rows, then seeded gallery rows
        gone = sorted({index32.paths[j] for j in got[:, :4].ravel()
                       if not index32.paths[j].startswith("self/")})[:N_REMOVE11]
        extra = np.random.default_rng(113).choice(N_ROWS, N_REMOVE11, replace=False)
        gone = list(dict.fromkeys(gone + [f"gallery/{i:07d}" for i in extra]))[:N_REMOVE11]
        removed = server.remove_images(gone)
        again, _, _ = serve_wave(server, queries)
        k1 += fa.layer_block_int8.launches
        if server.ann is not ivf or removed != len(gone):
            fail(f"remove_images: {removed} of {len(gone)} removed, IVF attached "
                 f"{server.ann is ivf}")
        back = {h["path"] for ans in again for h in ans} & set(gone)
        if back:
            fail(f"removed rows returned by the IVF server: {sorted(back)[:3]}")
        check_ivf_hits("SearchServer(ann=ivf) after removals", index32, ivf, q_emb, again,
                       NPROBE11)
        print(f"{ok} images inserted through SearchServer.add_images (rows {first}.."
              f"{first + ok - 1}, the IVF attached with a tail of {ivf.tail_count} rows, each "
              f"of 16 found first by its own image query); {removed} rows removed, never "
              f"returned in a second wave of {N_CLIENTS}", flush=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    del ivf, server, searcher
    torch.cuda.empty_cache()
    return k1, out


def ivf_operating_point(torch, card):
    """Phase 11 B: 2^23 clustered rows at recommended_ivf's (4096, 8) int8
    operating point against the exact int8 tier; offload, save / load.
    Returns readings, among them the 2^20-row single-query samples of C."""
    import dataclasses
    import shutil
    import tempfile

    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.index.ivf import IVFIndex, recommended_ivf

    d, out = 512, {}
    t0 = time.perf_counter()
    rows, centres, _ = clustered_gallery(torch, N11, d, CLUSTERS11, seed=111)
    g = torch.Generator(device="cuda").manual_seed(112)
    qc = torch.randint(0, CLUSTERS11, (N_CLIENTS,), device="cuda", generator=g)
    qbatch = clustered_points(torch, centres, qc, g).cpu().numpy()
    del centres
    gen_s = time.perf_counter() - t0
    exact = ShardedVectorIndex(dim=d, config=IndexConfig(embedding_dim=d, dtype="int8",
                                                         capacity_step=N11))
    t0 = time.perf_counter()
    names = [f"c/{i:08d}" for i in range(N11)]
    for lo in range(0, N11, 1 << 22):
        exact.insert(names[lo: lo + (1 << 22)], rows[lo: lo + (1 << 22)])
    exact.load()
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    del names
    nlist, nprobe = recommended_ivf(N11)
    t0 = time.perf_counter()
    ivf = IVFIndex(nlist=nlist, nprobe=nprobe, dtype="int8").build(rows, train_size=TRAIN11)
    build_s = time.perf_counter() - t0
    parts = ", ".join(f"{k} {v:.2f} s" for k, v in ivf.build_seconds.items())
    print(f"{N11} x {d} clustered unit rows ({CLUSTERS11} planted clusters) made on the card "
          f"and copied to the host in {gen_s:.1f} s; the exact int8 tier over them in "
          f"{insert_s:.1f} s; recommended_ivf({N11}) = ({nlist}, {nprobe}); IVFIndex int8, "
          f"train_size {TRAIN11}, built in {build_s:.1f} s ({parts}), lmax {ivf._lmax} "
          f"({ivf._packed.numel() / 2**30:.2f} GiB of slabs); MemAvailable "
          f"{mem_available_gib():.1f} GiB [{card}]", flush=True)
    got = ivf.search(qbatch, TOP_K)
    want = exact.search(qbatch, TOP_K)
    rec = recall_at10(got[1], want[1])
    ivf_1 = host_ms(lambda: ivf.search(qbatch[0], TOP_K), 20)
    ivf_64 = host_ms(lambda: ivf.search(qbatch, TOP_K), 5)
    ex_1 = host_ms(lambda: exact.search(qbatch[0], TOP_K), 20)
    ex_64 = host_ms(lambda: exact.search(qbatch, TOP_K), 9)
    out.update(lmax=ivf._lmax, build_s=build_s, parts=ivf.build_seconds, recall=rec,
               p50_1=ivf_1, p50_64=ivf_64, exact_p50_1=ex_1, exact_p50_64=ex_64,
               sweep_gbps=N11 * (d + 4) / (ex_64 / 1e3) / 1e9)
    print(f"IVF ({nlist}, {nprobe}) over {N11} clustered rows: recall@10 vs the exact int8 "
          f"tier {rec:.4f}; p50 (host clock) one query IVF {ivf_1:.3f} ms vs exact "
          f"{ex_1:.3f} ms, 64 queries IVF {ivf_64:.3f} ms vs exact {ex_64:.3f} ms "
          f"(the exact sweep {out['sweep_gbps']:.1f} GB/s of int8 rows and scales) [{card}]",
          flush=True)

    ivf.offload()
    torch.cuda.empty_cache()
    off = ivf.search(qbatch, TOP_K)
    moved = ivf.last_upload_bytes
    if not (np.array_equal(off[1], got[1]) and np.array_equal(off[0], got[0])):
        fail("the offloaded IVF's answers differ from the resident ones")
    off_1 = host_ms(lambda: ivf.search(qbatch[0], TOP_K), 20)
    off_64 = host_ms(lambda: ivf.search(qbatch, TOP_K), 5)
    parts, slabs = offload_breakdown(torch, ivf, qbatch)
    out.update(offload_p50_1=off_1, offload_p50_64=off_64, offload_bytes_64=moved,
               offload_parts_64=parts)
    print(f"offloaded ({ivf._host_packed.nbytes / 2**30:.2f} GiB of pinned host slabs): "
          f"answers bit for bit the resident ones; p50 one query {off_1:.3f} ms, 64 queries "
          f"{off_64:.3f} ms (host clock); {moved / 2**30:.3f} GiB uploaded for the 64-query "
          f"batch ({slabs} unique slabs) vs {N11 * d / 2**30:.1f} GiB an exact streamed "
          f"sweep moves; parts of the batch (one thread's gather): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f" [{card}]", flush=True)

    folder = work_root("chip_smoke_ivf_")
    try:
        path = os.path.join(folder, "ivf.npz")
        t0 = time.perf_counter()
        ivf.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = IVFIndex.load(path)
        load_s = time.perf_counter() - t0
        again = back.search(qbatch, TOP_K)
        if not (np.array_equal(again[1], got[1]) and np.array_equal(again[0], got[0])):
            fail("the IVF loaded from its save answers differently")
        print(f"save {save_s:.1f} s ({os.path.getsize(path) / 2**30:.2f} GiB npz), load "
              f"{load_s:.1f} s (offloaded: {back._offloaded}), the same answers", flush=True)
        del back
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    del ivf, exact
    torch.cuda.empty_cache()

    # C: one query at 2^20 x 512 in each storage type: the card's time (the
    # p50 over five queries of torch.profiler's device time, four calls
    # each) and the host clock's; recall vs f32
    n = 1 << 20
    singles, host_singles, recalls, f32_ids = {}, {}, {}, None
    for dtype in ("float32", "bfloat16", "int8", "int4"):
        cfg = IndexConfig(embedding_dim=d, dtype=dtype, capacity_step=n)
        ix = ShardedVectorIndex(dim=d, config=cfg)
        ix.insert([f"r/{i}" for i in range(n)], rows[:n])
        ix.load()
        ids = ix.search(qbatch, TOP_K)[1]
        f32_ids = ids if dtype == "float32" else f32_ids
        recalls[dtype] = recall_at10(ids, f32_ids)
        dev = [device_ms(torch, lambda: ix.search(qbatch[j], TOP_K), calls=4) for j in range(5)]
        if None in dev:
            fail(f"torch.profiler recorded no device time for the {dtype} tier's search")
        singles[dtype] = float(np.median(dev))
        host_singles[dtype] = float(np.median([host_ms(lambda: ix.search(qbatch[j], TOP_K), 10)
                                               for j in range(5)]))
        del ix
        torch.cuda.empty_cache()
    out.update(single_ms=singles, single_host_ms=host_singles, dtype_recall=recalls)
    del rows
    return out


def phase_ivf(torch, card, enc, index32, queries, q_emb, upload_gbps=None):
    """Phase 11: the IVF tier and the planner. Returns (K1 launches, readings)."""
    from image_retrieval_tpu_torch.app import cli
    from image_retrieval_tpu_torch.index import plan as P
    from image_retrieval_tpu_torch.index.ivf import IVFIndex

    t_phase = time.perf_counter()
    host_empty_cache = getattr(torch._C, "_host_emptyCache", None)
    if host_empty_cache is not None:  # pinned blocks the caching allocator keeps
        host_empty_cache()
    free, total = torch.cuda.mem_get_info()
    usable = free + torch.cuda.memory_reserved() - P.SEARCH_HEADROOM_BYTES
    print(f"phase 11: MemAvailable {mem_available_gib():.1f} GiB; the card's memory "
          f"{total / 2**30:.2f} GiB, free + held by this process's allocator "
          f"{(usable + P.SEARCH_HEADROOM_BYTES) / 2**30:.2f} GiB", flush=True)
    k1, ref = ivf_reference_deployment(torch, card, enc, index32, queries, q_emb)
    op = ivf_operating_point(torch, card)

    # the upload rate: phase 10's reading, else one 2^22 x 512 pinned chunk
    if upload_gbps is None:
        host = torch.empty((1 << 22, 512), dtype=torch.int8, pin_memory=True)
        buf = torch.empty(host.shape, dtype=torch.int8, device="cuda")
        ms = event_ms(torch, lambda: buf.copy_(host, non_blocking=True), samples=3, reps=1,
                      warm=1)
        upload_gbps = host.numel() / (ms / 1e3) / 1e9
        del host, buf
    measured = {"USABLE_HBM_BYTES": (usable, P.USABLE_HBM_BYTES),
                "SWEEP_GBPS": (op["sweep_gbps"], P.SWEEP_GBPS),
                "PCIE_GBPS": (upload_gbps, P.PCIE_GBPS)}
    for dtype, ms in op["single_ms"].items():
        measured[f"SINGLE_Q_MS_1M[{dtype}]"] = (ms, P.SINGLE_Q_MS_1M[dtype])
    off = {}
    for name, (m, c) in measured.items():
        off[name] = abs(m - c) / c
        print(f"planner constant {name}: measured {m:.8g}, index/plan.py {c:.8g} "
              f"({100 * off[name]:.1f}% off, limit {100 * PLAN_TOLERANCE:.0f}%) [{card}]",
              flush=True)
    print("one query over 2^20 x 512 rows, host clock p50 (the card's time plus the host's "
          "launches and synchronizations; not held): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in op["single_host_ms"].items()), flush=True)
    for dtype, r in op["dtype_recall"].items():
        print(f"planner RECALL_AT_10[{dtype}] = {P.RECALL_AT_10[dtype]} (the JAX package's, "
              f"vs the f32 oracle); read here at 2^20 clustered rows vs the f32 tier: "
              f"{r:.4f}", flush=True)
    print(f"planner IVF_RECALL_CLUSTERED = {P.IVF_RECALL_CLUSTERED} (the JAX package's); read "
          f"here at 2^23 clustered rows vs the exact int8 tier: {op['recall']:.4f}", flush=True)
    for n in PLAN_ROWS11:
        for extra in ([], ["--clustered"]):
            print(f"$ cli plan --rows {n} {' '.join(extra)}", flush=True)
            cli.main(["plan", "--rows", str(n), *extra])

    # the JAX-written IVF fixture answers as the JAX package did
    with np.load(IVF_FIXTURE_ANSWERS) as z:
        q, want_v, want_i = z["queries"], z["scores"], z["ids"]
    for offloaded in (False, True):
        ivf = IVFIndex.load(IVF_FIXTURE)
        if offloaded:
            ivf.offload()
        v, i = ivf.search(q, top_k=want_i.shape[1])
        diff = float(np.abs(v - want_v).max())
        if not np.array_equal(i, want_i) or diff > 1e-6:
            fail(f"the JAX-written IVF ({'offloaded' if offloaded else 'resident'}) answers "
                 f"differently: ids equal {np.array_equal(i, want_i)}, score diff {diff:.3g}")
    print(f"{IVF_FIXTURE} (written by the JAX package: int8, replicas 2, a tail of "
          f"{ivf.tail_count} rows, custom paths) loaded on the card, resident and offloaded: "
          f"ids equal to the JAX answers, scores within {diff:.3g} (limit 1e-6)", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 11 took {seconds:.1f} s; MemAvailable {mem_available_gib():.1f} GiB",
          flush=True)
    bad = [n for n, o in off.items() if o > PLAN_TOLERANCE]
    if bad:
        fail(f"planner constants more than {100 * PLAN_TOLERANCE:.0f}% off the card's "
             f"readings: {bad}")
    return k1, {"reference": ref, "operating_point": op, "constants": measured,
                "seconds": seconds}


def phase_ivf_alone(torch, card):
    """--ivf: phase 11 on what phases 3 and 6 would hand it: the B/32
    serving encoder and its f32 gallery (256 encoded seeded images, N_ROWS
    seeded unit rows) with phase 6's planted rows, all from seed 0."""
    from image_retrieval_tpu_torch.config import Config, vit_b32_serving
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    enc = CLIPEncoder(Config(model=vit_b32_serving()), seed=0)
    words_a = ["red", "blue", "green", "small", "old", "shiny", "dark", "wet"]
    words_b = ["car", "dog", "house", "tree", "boat", "cat", "bridge", "clock"]
    queries = [f"a photo of a {a} {b}" for a in words_a for b in words_b][:N_CLIENTS]
    images = np.random.default_rng(0).integers(0, 256, size=(N_IMAGES, 224, 224, 3),
                                               dtype=np.uint8)
    index32 = ShardedVectorIndex(dim=512)
    index32.insert([f"images/{i:04d}.jpg" for i in range(N_IMAGES)], enc.encode_pixels(images))
    grng = np.random.default_rng(1)
    rows = grng.standard_normal((N_ROWS, 512), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index32.insert([f"gallery/{i:07d}" for i in range(N_ROWS)], rows,
                   grng.uniform(0.5, 4.0, N_ROWS).astype(np.float32),
                   attrs={"bucket": np.arange(N_ROWS) % 8})
    del rows
    q_emb = enc.encode_texts(queries)
    plant_rows(torch, index32, q_emb, 61)
    return phase_ivf(torch, card, enc, index32, queries, q_emb)


# ---- phase 12: the color-analysis slice --------------------------------------

# The dataset: 10 categories x 3 colours x 20 synthetic examples (600 images,
# 179,700 relationship pairs); the CLI's `analyze` at the reference's default
# of 5 (150 images); the weight grid of optimize_weights(grid_size=3).
N_EXAMPLES12, PAIRS12, CLI_EXAMPLES12, GRID12 = 20, 179_700, 5, 3
BATCH12 = 100  # run_workflow's and Config.batch_size's loader batch
# device (f32) against strict (float64) pair tables: 1e-5 + 1e-5 |v|; MI of
# the two within the JAX package's own limit
# (tests/test_analysis.py::test_device_precision_close_to_strict); the grid's
# MI on the card against the same function on the CPU
TABLE_TOL12, MI_ATOL12, GRID_MI_ATOL12 = 1e-5, 5e-3, 1e-5


def timed_encode_folder(seconds):
    """A context in which data.loader.encode_folder (the workflow's step 2
    and the app's ingest) appends its wall seconds and image count to
    `seconds`."""
    import contextlib

    from image_retrieval_tpu_torch.data import loader

    @contextlib.contextmanager
    def ctx():
        real = loader.encode_folder

        def timed(encoder, paths, *a, **kw):
            t0 = time.perf_counter()
            out = real(encoder, paths, *a, **kw)
            seconds.append((time.perf_counter() - t0, len(out[0])))
            return out

        loader.encode_folder = timed
        try:
            yield
        finally:
            loader.encode_folder = real

    return ctx()


def phase_analysis(torch, card):
    """Phase 12 (see the module docstring). Returns (K1 launches, readings)."""
    import itertools
    import shutil

    from PIL import Image

    from image_retrieval_tpu_torch.analysis import plots
    from image_retrieval_tpu_torch.analysis.color_mi import METRIC_NAMES, ColorMIAnalyzer
    from image_retrieval_tpu_torch.app.workflow import run_workflow
    from image_retrieval_tpu_torch.config import Config, vit_b32, vit_b32_serving
    from image_retrieval_tpu_torch.data.color import dominant_colors_batch
    from image_retrieval_tpu_torch.data.dataset import prepare_color_dataset
    from image_retrieval_tpu_torch.ops import flash_attention as fa
    from image_retrieval_tpu_torch.ops.binning import discretize_uniform
    from image_retrieval_tpu_torch.ops.mi import mutual_info_uniform

    t_phase = time.perf_counter()
    secs = {}
    drawn = plots.available()
    work = work_root("chip_smoke_analysis_")
    try:
        # ---- A: the dataset, and its dominant colours on the card and CPU --
        ds = os.path.join(work, "color_dataset")
        t0 = time.perf_counter()
        pairs, meta = prepare_color_dataset(base_dir=ds, num_examples=N_EXAMPLES12)
        secs["dataset"] = time.perf_counter() - t0
        counts = {k: len(v) for k, v in pairs.items()}
        print(f"phase 12: prepare_color_dataset(synthetic, num_examples={N_EXAMPLES12}): "
              f"{len(meta)} images, pairs {counts} = {sum(counts.values())} in "
              f"{secs['dataset']:.2f} s (host; the dataset_examples.png grid "
              f"{'drawn' if drawn else 'not drawn: no matplotlib here'})", flush=True)
        if len(meta) != 30 * N_EXAMPLES12 or sum(counts.values()) != PAIRS12:
            fail(f"the dataset holds {len(meta)} images and {sum(counts.values())} pairs")
        images = [np.asarray(Image.open(m["path"]).convert("RGB")) for m in meta]
        names = {}
        for dev in ("cuda", "cpu"):
            dominant_colors_batch(images[:8], device=dev)  # warm
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            names[dev] = dominant_colors_batch(images, device=dev)
            secs[f"colors_{dev}"] = time.perf_counter() - t0
        if names["cuda"] != names["cpu"]:
            bad = [i for i, (a, b) in enumerate(zip(names["cuda"], names["cpu"])) if a != b]
            fail(f"dominant colours on the card differ from the CPU's at {len(bad)} images, "
                 f"e.g. {meta[bad[0]]['path']}: {names['cuda'][bad[0]]} vs {names['cpu'][bad[0]]}")
        found = {c: names["cuda"].count(c) for c in sorted(set(names["cuda"]))}
        same = sum(n == m["color"] for n, m in zip(names["cuda"], meta))
        print(f"dominant_colors_batch (k-means, 3 centres, 10 steps, 4,096 pixels an image) "
              f"over the {len(images)} JPEGs: the card's names equal the CPU's ({found}; "
              f"{same} equal the folder's colour: the background is the largest cluster, and "
              f"tests/test_dataset.py::test_synth_images_have_right_dominant_color holds no "
              f"colour, only the size); card {secs['colors_cuda']:.3f} s, CPU "
              f"{secs['colors_cpu']:.3f} s [{card}]", flush=True)

        # ---- B: the workflow through K1, and the plain route -------------
        enc_s = {}
        results, emb = {}, {}
        for name, model in (("k1", vit_b32_serving()), ("plain", vit_b32())):
            out = os.path.join(work, f"workflow_{name}")
            seconds = []
            if name == "k1":
                fa.layer_block_int8.launches = 0
            t0 = time.perf_counter()
            with timed_encode_folder(seconds):
                results[name] = run_workflow(output_dir=out, dataset_dir=ds,
                                             config=Config(model=model))
            secs[f"workflow_{name}"] = time.perf_counter() - t0
            if name == "k1":
                k1_workflow = fa.layer_block_int8.launches
            if not results[name] or set(results[name]) != {"general_mi", "color_mi",
                                                            "optimal_weights"}:
                fail(f"run_workflow ({name}) returned {results[name]}")
            enc_s[name], n_enc = seconds[0]
            with np.load(os.path.join(out, "color_embeddings.npz"), allow_pickle=True) as z:
                emb[name] = z["embeddings"].item()
            if n_enc != len(meta) or len(emb[name]) != len(meta):
                fail(f"the {name} workflow embedded {n_enc} of {len(meta)} images")
        chunks = sum(encoder_chunks(min(BATCH12, len(meta) - i))
                     for i in range(0, len(meta), BATCH12))
        paths = list(emb["k1"])
        cos = row_cos(torch.from_numpy(np.stack([emb["k1"][p] for p in paths])),
                      torch.from_numpy(np.stack([emb["plain"][p] for p in paths])))
        print(f"run_workflow over the {len(meta)} images (skip_dataset): vit_b32_serving() "
              f"{secs['workflow_k1']:.2f} s (encode {enc_s['k1']:.2f} s, "
              f"{len(meta) / enc_s['k1']:.1f} img/s with the PIL decode), layer_block_int8 "
              f"launches {k1_workflow} (expected 12 x {chunks} image batches); plain "
              f"vit_b32() {secs['workflow_plain']:.2f} s (encode {enc_s['plain']:.2f} s, "
              f"{len(meta) / enc_s['plain']:.1f} img/s); row cosine K1 vs plain min "
              f"{float(cos.min()):.6f}, mean {float(cos.mean()):.6f} (limit "
              f"{TOWER_MIN_COS}) [{card}]", flush=True)
        if k1_workflow != 12 * chunks:
            fail(f"the workflow ran layer_block_int8 {k1_workflow} times, not 12 x {chunks}")
        if float(cos.min()) < TOWER_MIN_COS:
            fail(f"K1 embeddings vs the plain route: row cosine {float(cos.min()):.6f}")
        print("results.json, vit_b32_serving() | vit_b32() (not held: binning is "
              "discontinuous):", flush=True)
        for part in ("general_mi", "color_mi", "optimal_weights"):
            for key, v in results["k1"][part].items():
                print(f"  {part}.{key}: {v:.6f} | {results['plain'][part][key]:.6f}", flush=True)

        # ---- C: the analysis, device tables against strict ----------------
        npz = os.path.join(work, "workflow_k1", "color_embeddings.npz")
        strict = ColorMIAnalyzer(base_dir=ds, precision="strict")
        device = ColorMIAnalyzer(base_dir=ds, precision="device", device="cuda")
        worst = {}
        for name, an in (("strict", strict), ("device", device)):
            ok, msg = an.load_dataset(npz)
            if not ok:
                fail(f"ColorMIAnalyzer ({name}) could not load {npz}: {msg}")
            t0 = time.perf_counter()
            for rel in an.relationship_types:
                an._table_for(rel)
            an._color_table()
            secs[f"tables_{name}"] = time.perf_counter() - t0
        for rel in strict.relationship_types + ["color"]:
            ts, td = ((strict._color_table()[0], device._color_table()[0]) if rel == "color"
                      else (strict._table_for(rel), device._table_for(rel)))
            for m in list(METRIC_NAMES) + ["cosine_similarity"]:
                excess = np.abs(td[m] - ts[m]) - TABLE_TOL12 * (1 + np.abs(ts[m]))
                worst[(rel, m)] = float(np.abs(td[m] - ts[m]).max())
                if excess.max() > 0:
                    fail(f"device table {rel}.{m} off the float64 one by "
                         f"{worst[(rel, m)]:.3g} (limit 1e-5 + 1e-5 |v|)")
        mi = {}
        for name, an in (("strict", strict), ("device", device)):
            mi[name] = (an.calculate_mutual_information(), an.calculate_color_specific_mi())
        mi_diff = max(abs(mi["device"][i][m] - mi["strict"][i][m])
                      for i in (0, 1) for m in METRIC_NAMES)
        print(f"ColorMIAnalyzer tables over the {PAIRS12} pairs and the "
              f"{len(strict._color_table()[1])} colour pairs: strict (host float64) "
              f"{secs['tables_strict']:.2f} s, device (f32 pair_metrics on the card, with the "
              f"gathers and copies) {secs['tables_device']:.2f} s; largest difference "
              f"{max(worst.values()):.3g} ({max(worst, key=worst.get)}; limit 1e-5 + 1e-5 |v|); "
              f"general and colour MI within {mi_diff:.3g} (limit {MI_ATOL12}) [{card}]",
              flush=True)
        if mi_diff > MI_ATOL12:
            fail(f"device-precision MI off the strict MI by {mi_diff:.3g}")

        # the grid search: on the host (the analyzer's), then the same 243
        # combinations' binning and MI on the card and on the CPU
        t0 = time.perf_counter()
        best = strict.optimize_weights(grid_size=GRID12)
        secs["grid_host"] = time.perf_counter() - t0
        table, labels = strict._color_table()
        basis = np.stack([-table["cosine_similarity"], table["l1_distance"],
                          table["l2_distance"], table["linf_distance"],
                          table["magnitude_difference"]], axis=1)
        grid = np.linspace(0.0, 1.0, GRID12)
        combos = np.array(list(itertools.product(grid, repeat=5)))  # the analyzer's order
        scores = (combos @ basis.T).astype(np.float32)  # (243, P)
        got = {}
        for dev in ("cuda", "cpu"):
            vals = torch.from_numpy(scores).to(dev)
            lab = torch.from_numpy(labels).to(dev)
            run = lambda: mutual_info_uniform(vals, lab, strict.bin_count, 2)
            if dev == "cuda":
                secs["grid_mi_cuda_ms"] = event_ms(torch, run, samples=5, reps=3, warm=2)
            else:
                t0 = time.perf_counter()
                run()
                secs["grid_mi_cpu_ms"] = (time.perf_counter() - t0) * 1e3
            got[dev] = (discretize_uniform(vals, strict.bin_count).cpu().numpy(),
                        run().cpu().numpy())
        same_bins = np.array_equal(got["cuda"][0], got["cpu"][0])
        grid_diff = float(np.abs(got["cuda"][1] - got["cpu"][1]).max())
        dev_best = dict(zip(("w_angle", "w_l1", "w_l2", "w_inf", "w_mag"),
                            map(float, combos[int(np.argmax(got["cuda"][1]))])))
        print(f"the weight grid ({len(combos)} combinations x {scores.shape[1]} colour pairs): "
              f"host search (optimize_weights, float64, analysis_grid_ms) "
              f"{secs['grid_host'] * 1e3:.1f} ms, best {best}; mutual_info_uniform (f32) on "
              f"the card {secs['grid_mi_cuda_ms']:.3f} ms (CUDA events), on the CPU "
              f"{secs['grid_mi_cpu_ms']:.1f} ms; bins card = CPU: {same_bins}; MI within "
              f"{grid_diff:.3g} (limit {GRID_MI_ATOL12}); the f32 grid's best {dev_best} "
              f"[{card}]", flush=True)
        if not same_bins:
            fail("discretize_uniform on the card differs from the CPU's")
        if grid_diff > GRID_MI_ATOL12:
            fail(f"mutual_info_uniform on the card off the CPU's by {grid_diff:.3g}")

        # ---- D: the CLI on the card ----------------------------------------
        cli_root = os.path.join(work, "cli")
        t0 = time.perf_counter()
        printed = run_cli_in(os.path.join(cli_root, "analyze"), [
            "analyze", "--synthetic", "--num_examples", str(CLI_EXAMPLES12),
            "--output_dir", "out"])
        secs["cli_analyze"] = time.perf_counter() - t0
        with open(os.path.join(cli_root, "analyze", "out", "analysis_results",
                               "results.json")) as f:
            keys = set(json.load(f))
        if keys != {"general_mi", "color_mi", "optimal_weights"}:
            fail(f"cli analyze wrote results.json with {keys}")
        print(f"cli analyze --synthetic (num_examples {CLI_EXAMPLES12}: "
              f"{30 * CLI_EXAMPLES12} images, plain vit_b32() on the card): exit 0 in "
              f"{secs['cli_analyze']:.1f} s, results.json has {sorted(keys)} [{card}]",
              flush=True)
        k1_cli = 0
        geometric = ["geometric", "--folder", ds, "--fast-encoder", "--optimize",
                     "--grid-size", str(GRID12), "--ci"]
        if drawn:
            geometric += ["--plot", "mi.png"]
        for argv in (["mi", "--folder", ds, "--fast-encoder"], geometric):
            fa.layer_block_int8.launches = 0
            t0 = time.perf_counter()
            printed = run_cli_in(os.path.join(cli_root, argv[0]), argv)
            secs[f"cli_{argv[0]}"] = time.perf_counter() - t0
            launches = fa.layer_block_int8.launches
            k1_cli += launches
            print(f"$ cli {' '.join(a if a != ds else '<dataset>' for a in argv)}: exit 0 in "
                  f"{secs[f'cli_{argv[0]}']:.1f} s, layer_block_int8 launches {launches} "
                  f"(expected 12 x {chunks}) [{card}]\n" + printed.rstrip(), flush=True)
            if launches != 12 * chunks:
                fail(f"cli {argv[0]} ran layer_block_int8 {launches} times, not 12 x {chunks}")
        if not drawn:
            print("matplotlib is not installed here: the analyses ran with make_plots=False "
                  "(results.json only) and `geometric` without --plot; the CPU tests hold "
                  "every plot", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    k1 = k1_workflow + k1_cli
    secs["phase"] = time.perf_counter() - t_phase
    print(f"phase 12 took {secs['phase']:.1f} s; layer_block_int8 launches {k1} "
          f"({k1_workflow} the workflow, {k1_cli} the CLI's mi and geometric) [{card}]",
          flush=True)
    return k1, {"seconds": secs, "table_diff": max(worst.values()), "mi_diff": mi_diff,
                "grid_mi_diff": grid_diff}


def main() -> int:
    if sys.argv[1:2] == ["--durable-child"]:  # phase 9's crashing server
        durable_child(*sys.argv[2:6])
        return 3  # not reached: the child kills itself once it has answered
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

    if sys.argv[1:] == ["--time-k1"]:
        # only the int8 layer kernels' times (event and device), the launch
        # breakdown of K1 and of K2a + K2b, the int8 GEMM stages alone and
        # the L/14 int8 image batch's profile: to compare two checkouts
        # inside one call on one card, copy this script into each and run it
        # there in turns
        from image_retrieval_tpu_torch.ops import flash_attention as fa

        time_kernels(torch, card, kernel_runs(fa), TIME_SHAPES, device=True)
        launch_breakdown(torch, card)
        phase_gemm_stages(torch, card, halves=("mlp_block_int8",), only=("qkv", "out", "fc2"))
        profile_l14_int8_batch(torch, card)
        return 0
    if sys.argv[1:] == ["--time-dense"]:
        phase_time_dense(torch, card)
        return 0
    if sys.argv[1:] == ["--gemm-variants"]:
        # the bf16 GEMM as the library plans it beside the variants its
        # design was chosen from, each held bit for bit against it
        run_experiment(card, "gemm_bf16_variants", "gemm variants")
        return 0
    if sys.argv[1:] == ["--gemm-s8-variants"]:
        # the same for the int8 GEMM, beside the one-tile kernel it replaced
        run_experiment(card, "gemm_s8_variants", "gemm s8 variants")
        return 0
    if sys.argv[1:] == ["--time-metrics"]:
        phase_time_metrics(torch, card, lib_path)
        return 0
    if sys.argv[1:] == ["--time-k3"]:
        phase_time_k3(torch, card, lib_path)
        return 0
    if sys.argv[1:] == ["--k3-variants"]:
        k3_variants(card)
        return 0
    if sys.argv[1:] == ["--rowquant-variants"]:
        # the fused fc1 stage, the two launches it replaces and the variants
        # its design was chosen from, held bit for bit against it
        run_experiment(card, "rowquant_gemm_variants", "rowquant variants")
        return 0
    if sys.argv[1:] == ["--dense-readings"]:
        dense_readings(torch)
        return 0
    if sys.argv[1:] == ["--durable"]:
        print(f"phase 9 alone: K1 and K6 launches {phase_durable_alone(torch, card)}",
              flush=True)
        return 0
    if sys.argv[1:] == ["--tiers"]:
        print(f"phase 10 alone: K3 launches {phase_tiers_alone(torch, card)[0]}", flush=True)
        return 0
    if sys.argv[1:] == ["--ivf"]:
        print(f"phase 11 alone: K1 launches {phase_ivf_alone(torch, card)[0]}", flush=True)
        return 0
    if sys.argv[1:] == ["--analysis"]:  # phase 12 builds its own dataset and encoders
        print(f"phase 12 alone: K1 launches {phase_analysis(torch, card)[0]}", flush=True)
        return 0
    print_new_kernel_registers(lib_path)
    if sys.argv[1:] == ["--gemm-stages"]:
        check_fused_stage(torch, card)
        phase_gemm_stages(torch, card)
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    kernels = phase_kernels(torch, card)
    kernels.update(phase_dense_kernels(torch, card))
    stages = phase_gemm_stages(torch, card)
    kernels.update(phase_train_kernel(torch, card))
    launches, enc, queries, q_emb, index32 = phase_slice(torch, card)
    int4_launches, k3, k12 = phase_int4(torch, card, enc, queries, q_emb)
    torch.cuda.empty_cache()
    l14_launches, enc14, index14 = phase_l14(torch, card, queries)
    torch.cuda.empty_cache()
    w_launches, w_err, w_times = phase_weighted(torch, card, enc, index32, enc14, index14,
                                                queries)
    # phase 9 runs here, while phase 3's encoder and gallery and phase 5's
    # encoder are on the card
    k1_durable, k6_durable = phase_durable(torch, card, enc, enc14, index32, queries)
    torch.cuda.empty_cache()
    # phase 10 runs here, while phase 5's encoder and gallery are on the card
    k3_streamed, tiers = phase_tiers(torch, card, enc14, index14, queries, q_emb)
    del enc14
    torch.cuda.empty_cache()
    # phase 11 runs here, phase 10's pinned rows freed, on phase 3's encoder
    # and gallery (with phase 6's planted rows)
    k1_ivf, _ = phase_ivf(torch, card, enc, index32, queries, q_emb,
                          upload_gbps=tiers["int8"]["h2d_gbps"])
    del enc, index32
    torch.cuda.empty_cache()
    # phase 12 after phase 11: the color-analysis slice on its own dataset
    k1_analysis, _ = phase_analysis(torch, card)
    torch.cuda.empty_cache()
    d_launches = phase_dense(torch, card, queries, index14)
    del index14
    torch.cuda.empty_cache()
    t_launches, train = phase_train(torch, card)
    for name in DENSE_KERNELS:  # K9a and K9b also run on the trainer's path
        d_launches[name] += t_launches[name]

    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "image_retrieval_tpu")]
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded[:5]}")

    def block_entry(name, source, line, n_launches, case, extra):
        k = kernels[name]
        t = k["times"][case]
        entry = {"name": name, "route": "cuda",
                 "source": f"image_retrieval_tpu_torch/csrc/{source}",
                 "replaces": f"image_retrieval_tpu/ops/flash_attention.py:{line}",
                 "launches": n_launches, "max_abs_err": k["max_abs_err"],
                 "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t.get("library_ms"), "shape": case}
        for lib_key in ("device_ms", "library_device_ms"):
            if lib_key in t:
                entry[lib_key] = t[lib_key]
        for key, other in extra.items():
            o = k["times"][other]
            entry.update({f"{key}_ms": o["kernel"], f"{key}_plain_ms": o["plain"],
                          f"{key}_bound_ms": o["bound_ms"]})
            for lib_key in ("library_ms", "device_ms", "library_device_ms"):
                if lib_key in o:
                    entry[f"{key}_{lib_key}"] = o[lib_key]
        return entry

    def stage_entries(by_case):
        """The GEMM stages alone (q/k/v and out of an attention half, fc1 and
        fc2 of an MLP half): at the L/14 batch as qkv_ms, fc2_ms, ...; at the
        B/32 batch under a b32_vision_b256_ prefix."""
        out = {}
        for case, prefix in ((big, ""), ("b32-vision-B256", "b32_vision_b256_")):
            for stage, r in by_case[case].items():
                out.update({f"{prefix}{stage}_ms": r["kernel"],
                            f"{prefix}{stage}_plain_ms": r["plain"],
                            f"{prefix}{stage}_library_ms": r["library_ms"],
                            f"{prefix}{stage}_device_ms": r["device_ms"],
                            f"{prefix}{stage}_library_device_ms": r["library_device_ms"],
                            f"{prefix}{stage}_bound_ms": r["bound_ms"]})
                for key in ("pair_ms", "in_turns_ms", "pair_device_ms"):
                    if key in r:  # the fused stage beside the two launches it replaces
                        out[f"{prefix}{stage}_{key}"] = r[key]
        return out

    w_launches["fused_all_metrics"] += k6_durable  # the CLI's compare (phase 9)

    def metric_entry(name, entry, lines, main, extra):
        t = w_times[name]
        out = {"name": name, "route": "cuda",
               "source": "image_retrieval_tpu_torch/csrc/fused_metrics.cu",
               "replaces": " and ".join(f"image_retrieval_tpu/ops/pallas_kernels.py:{n}"
                                        for n in lines),
               "entry": entry, "launches": w_launches[name], "max_abs_err": w_err[name],
               "ms": t[main]["kernel"], "plain_ms": t[main]["plain"],
               "bound_ms": t[main]["bound_ms"], "bound_by": t[main]["bound_by"],
               "library_ms": None, "shape": f"{main}: {t[main]['shape']}"}
        for key, case in extra.items():
            out.update({f"{key}_ms": t[case]["kernel"], f"{key}_plain_ms": t[case]["plain"],
                        f"{key}_bound_ms": t[case]["bound_ms"],
                        f"{key}_bound_by": t[case]["bound_by"]})
        for key, case in {"": main, **{f"{k}_": c for k, c in extra.items()}}.items():
            # the bound as counted before (K5: before PR 11; K4, K6, K7: before PR 16)
            for field in ("old_bound_ms", "device_ms", "index_sweep_ms"):
                if field in t[case]:
                    out[f"{key}{field}"] = t[case][field]
        return out

    # the int4 screens at Q = 64 and 1 over one segment (screen_bound)
    seg, d = k3["rows"], q_emb.shape[1]
    vision_b, text_b = TRAIN_TIME_SHAPES
    big = f"l14-vision-B{ENC_BUCKET5}"
    print(card, flush=True)
    print(json.dumps({"kernels": [
        block_entry("layer_block_int8", "layer_block_int8.cu", 772,
                    launches + l14_launches["layer_block_int8"] + k1_durable + k1_ivf
                    + k1_analysis,
                    "b32-vision-B256",
                    {"b32_text_b64": "b32-text-B64", "l14_text_b64": "l14-text-B64",
                     "b32_vision_b8": "b32-vision-B8", "b32_text_b8": "b32-text-B8"}),
        {"name": "int4_screen", "route": "cuda",
         "source": "image_retrieval_tpu_torch/csrc/int4_screen.cu",
         "replaces": "image_retrieval_tpu/ops/pallas_kernels.py:602",
         "launches": int4_launches + k3_streamed,
         "max_abs_err": max(k3[1]["max_abs_err"], k3[64]["max_abs_err"],
                            tiers["k3_chunk"][64]["max_abs_err"]),
         "ms": k3[64]["kernel"], "plain_ms": k3[64]["plain"], "bound_ms": k3[64]["bound_ms"],
         "bound_by": k3[64]["bound_by"], "library_ms": None, "shape": f"Q64 x {seg} rows x {d}",
         "q1_ms": k3[1]["kernel"], "q1_plain_ms": k3[1]["plain"],
         "q1_bound_ms": k3[1]["bound_ms"],
         # phase 10: the streamed int4 tier's packed chunks, a segment each launch
         "streamed_launches": k3_streamed,
         "streamed_chunk_segment_ms": tiers["k3_chunk"][64]["kernel"],
         "streamed_chunk_segment_plain_ms": tiers["k3_chunk"][64]["plain"]},
        dict(block_entry("attention_block_int8", "attention_block_int8.cu", 554,
                         l14_launches["attention_block_int8"], big, {"b4": "l14-vision-B4"}),
             **stage_entries(stages["attention_block_int8"])),
        dict(block_entry("mlp_block_int8", "mlp_block_int8.cu", 671,
                         l14_launches["mlp_block_int8"], big,
                         {"b4": "l14-vision-B4", "b32_vision_b256": "b32-vision-B256",
                          "b32_vision_b8": "b32-vision-B8"}),
             **stage_entries(stages["mlp_block_int8"])),
        # no single PyTorch call computes any of the four: library_ms is null
        metric_entry("fused_optimized_topk", "fused_optimized_topk", (399,),
                     "q64-cosine-only", {"q64_reference": "q64-reference",
                                         "q1": "q1-cosine-only", "q1_reference": "q1-reference"}),
        metric_entry("fused_optimized_scores_int8",
                     "fused_optimized_scores_int8_pallas, ..._pallas_v2", (162, 275),
                     "q64-reference", {"q64_default": "q64-default", "q1_default": "q1-default"}),
        dict(metric_entry("fused_all_metrics", "fused_all_metrics", (45,), "q64",
                          {"q1": "q1", "int8_block": "int8-block-q64",
                           "int8_block_q1": "int8-block-q1"}),
             **{f"int8_multi_metric_topk_{q}_{k}": v
                for q, r in w_times["multi_metric_topk_int8"].items() for k, v in r.items()}),
        metric_entry("fused_optimized_scores", "fused_optimized_scores", (124,),
                     "q64-all-live", {"q1": "q1-all-live"}),
        # K8-K9b: no single PyTorch call computes a layer or a half of one.
        # K10: one scaled_dot_product_attention call computes the same function
        block_entry("layer_block", "layer_block.cu", 931, d_launches["layer_block"],
                    "b32-vision-B256",
                    {"b32_text_b64": "b32-text-B64", "l14_text_b64": "l14-text-B64",
                     "b32_vision_b8": "b32-vision-B8", "b32_text_b8": "b32-text-B8"}),
        dict(block_entry("attention_block", "attention_block.cu", 346,
                         d_launches["attention_block"], big,
                         {"b4": "l14-vision-B4", "b32_vision_b256": "b32-vision-B256",
                          "b32_vision_b8": "b32-vision-B8"}),
             **stage_entries(stages["attention_block"])),
        dict(block_entry("mlp_block", "mlp_block.cu", 457, d_launches["mlp_block"], big,
                         {"b4": "l14-vision-B4", "b32_vision_b256": "b32-vision-B256",
                          "b32_vision_b8": "b32-vision-B8",
                          f"b32_vision_b{N_PAIRS}": f"b32-vision-B{N_PAIRS}"}),
             **stage_entries(stages["mlp_block"])),
        block_entry("multihead_attention", "multihead_attention.cu", 87,
                    d_launches["multihead_attention"], "b32-vision-B256",
                    {"b32_vision_b8": "b32-vision-B8", "l14_vision_b128": big,
                     "b32_text_b64_causal": "b32-text-B64"}),
        # K11 and K12: no single PyTorch call computes either
        dict(block_entry("attention_block_train", "attention_block_train.cu", 1051,
                         t_launches["attention_block_train"], vision_b, {"b32_text": text_b}),
             k9a_ms=kernels["attention_block_train"]["times"][vision_b]["k9a_ms"],
             b32_text_k9a_ms=kernels["attention_block_train"]["times"][text_b]["k9a_ms"],
             backward_ms=train["backward"][vision_b]["saved_ms"],
             backward_recompute_ms=train["backward"][vision_b]["recompute_ms"],
             b32_text_backward_ms=train["backward"][text_b]["saved_ms"],
             b32_text_backward_recompute_ms=train["backward"][text_b]["recompute_ms"],
             step_ms=train["step_ms"], unfused_step_ms=train["plain_step_ms"]),
        {"name": "int4_screen_i8", "route": "cuda",
         "source": "image_retrieval_tpu_torch/csrc/int4_screen.cu",
         "replaces": "image_retrieval_tpu/ops/pallas_kernels.py:636",
         "launches": k12["launches"],
         "max_abs_err": max(k12[1]["max_abs_err"], k12[64]["max_abs_err"]),
         "ms": k12[64]["kernel"], "plain_ms": k12[64]["plain"],
         "bound_ms": k12[64]["bound_ms"], "bound_by": k12[64]["bound_by"],
         "library_ms": None, "shape": f"Q64 x {seg} rows x {d}",
         "q1_ms": k12[1]["kernel"], "q1_plain_ms": k12[1]["plain"],
         "q1_bound_ms": k12[1]["bound_ms"],
         "k3_ms": k12[64]["k3_ms"], "q1_k3_ms": k12[1]["k3_ms"],
         "top128_of_bf16": k12["top128"], "top10_of_bf16": k12["top10"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
