"""Image ingest through the program's CLIPEncoder.encode_stream: batches of
raw uint8 pixels go in, embeddings come back to the host, with the
encoder's in-flight window between the two.

Set-up: the towers' weights on the device from the seed, the encoder, and a
pool of `pool_batches` distinct batches of `batch` images at the model's
image size, made on the device from the seed and cycled through the stream.
Warm-up: the stream runs for `warmup_s` (every batch has the one shape).
The window opens at the return of a batch and closes at the first return
`--seconds` after it, so it counts whole batches over exactly their time.

Correct: a sample of the pool's images, drawn from the seed, is embedded by
the reference once the program's state is freed; every embedding the
program returned for those images during the run is held to it.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from bench_port import compare, inputs, profiling
from bench_port.harness import Run

RANGES = ("encoder.encode_stream",)


def run(ctx) -> Run:
    import torch

    from image_retrieval_tpu_torch.config import Config
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    cuda = str(ctx.device).startswith("cuda")
    model, tr = ctx.config["model"], ctx.traffic
    pool_n, batch = int(tr["pool_batches"]), int(tr["batch"])

    weights = inputs.make_weights(model, ctx.seed, ctx.device)
    enc = CLIPEncoder(Config(model=ctx.model_config), params=weights, device=ctx.device)
    del weights
    pool = inputs.make_pixels(pool_n, batch, int(model["image_size"]), ctx.seed, ctx.device)
    rng = np.random.default_rng(inputs.derive(ctx.seed, "check"))
    picks = sorted(int(i) for i in rng.choice(pool_n * batch, int(tr["check"]["images"]),
                                              replace=False))
    by_batch = {}
    for k, i in enumerate(picks):
        by_batch.setdefault(i // batch, []).append((i % batch, k))
    outputs = [[] for _ in picks]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)

    profiler = profiling.Profiler(ctx.device) if ctx.trace else None
    state = {"stop": False}

    def feed():
        i = 0
        while not state["stop"]:
            yield i, pool[i % pool_n]
            i += 1

    stream = iter(enc.encode_stream(feed()))
    t_warm = time.perf_counter() + float(tr["warmup_s"])
    t0 = t1 = None
    fetched = bad = 0
    host_ms, dispatched = [], []
    while True:
        if profiler is not None:
            profiler.poll()
        a = time.perf_counter()
        with profiling.span(ctx.trace, "encoder.encode_stream"):
            try:
                i, emb = next(stream)
            except StopIteration:
                break
        b = time.perf_counter()
        emb = np.asarray(emb)
        ok = emb.shape == (batch, model["embed_dim"]) and bool(np.isfinite(emb).all())
        for row, k in by_batch.get(i % pool_n, ()):
            outputs[k].append(emb[row].copy() if ok else np.full(model["embed_dim"], np.nan))
        if t0 is None:
            if b >= t_warm and i >= pool_n:
                t0 = b
                if profiler is not None:
                    start = t0 + 0.35 * ctx.seconds
                    profiler.arm(start, min(float(tr["profile_s"]), 0.3 * ctx.seconds))
        elif t1 is None:
            fetched += 1
            bad += 0 if ok else 1
            host_ms.append((b - a) * 1e3)
            dispatched.append(a)
            if b >= t0 + ctx.seconds:
                t1 = b
                state["stop"] = True
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    out = Run(attempted=fetched * batch, failed=bad * batch, images=fetched * batch,
              batch=batch, host_ms=host_ms, setup_s=t0 - ctx.t_process, window_s=t1 - t0,
              memory_peak_bytes=memory_peak)
    if ctx.trace:
        out.profiler, out.dispatched = profiler, dispatched
        out.trace = profiler.summary(RANGES)
    del stream, enc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    pixels = np.stack([pool[i // batch][i % batch] for i in picks])
    out.checks = compare.image_checks(ctx.config, ctx.seed, ctx.device, pixels, outputs)
    return out
