"""Text search through the program's SearchServer, driven by closed-loop
clients (`Clients`): each client thread sends a query (SearchServer.search),
or a burst of them (search_many), and its next one only when the last is
answered.

Set-up: the towers' weights and the gallery rows are made on the device
from the seed; the encoder (CLIPEncoder) takes the weights, the index
(ShardedVectorIndex, the configuration's tier) takes the rows in chunks
through insert(), and the server (SearchServer, its defaults) stages the
gallery on the device. Warm-up: the text tower at each batch size the
ladder pads to, each metric's sweep at a spread of group sizes, then the
clients for `warmup_s` before the window opens.

Correct: from the requests answered in the window a sample per metric of
the mix is drawn from the seed. The text tower is held to the reference on
the sampled queries' texts (the reference tokenizes them itself); the sweep
and the server's answers (paths and scores) are held to the reference's
sweep over the same gallery rows, from the query embeddings the program's
text tower produced for those requests, recorded as the timed path made
them. The reference runs once the program's state is freed.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np

from bench_port import compare, inputs, profiling
from bench_port.harness import Run

RANGES = ("encoder.encode_texts", "encoder.tokenizer", "index.search")


class TextRecorder:
    """Stands in for the encoder's encode_texts: calls it, and keeps what the
    timed path produced for each text a client marked as `wanted` (a copy of
    its row of the batch's output) and how often such a text was encoded, and
    each call's host time and size."""

    def __init__(self, enc, trace: bool, profiler):
        self.fn, self.trace, self.profiler = enc.encode_texts, trace, profiler
        self.rows, self.count, self.calls, self.wanted = {}, {}, [], set()

    def __call__(self, texts):
        if self.profiler is not None:
            self.profiler.poll()
        t = time.perf_counter()
        with profiling.span(self.trace, "encoder.encode_texts"):
            out = self.fn(texts)
        self.calls.append((t, len(texts)))
        for i, s in enumerate(texts):
            if s in self.wanted:
                self.count[s] = self.count.get(s, 0) + 1
                self.rows.setdefault(s, np.array(out[i]))
        return out


class TokenizerSpan:
    """The encoder's tokenizer inside a range of its own (traced runs)."""

    def __init__(self, tok):
        self.tok = tok

    def __call__(self, *a, **kw):
        with profiling.span(True, "encoder.tokenizer"):
            return self.tok(*a, **kw)


class SearchRecorder:
    """Stands in for the index's search in a traced run: a range around each
    call and its (host time, queries, metric, weights)."""

    def __init__(self, index):
        self.fn, self.calls = index.search, []

    def __call__(self, queries, *a, **kw):
        t = time.perf_counter()
        with profiling.span(True, "index.search"):
            out = self.fn(queries, *a, **kw)
        self.calls.append((t, int(np.asarray(queries).reshape(-1, queries.shape[-1]).shape[0]),
                           kw.get("metric", "cosine_similarity"), kw.get("params")))
        return out


class Clients:
    """Closed-loop clients, a thread each: each of `clients` threads sends
    `burst` queries and sends the next when all are answered; a burst of 1
    goes through SearchServer.search, a larger one through search_many.
    Client c's k-th burst takes the mix entry `pattern[(c + k) %
    len(pattern)]` and the request ids ((k * clients + c) * burst + j), each
    the text QueryTexts gives it. A share `check.keep_share` of the bursts,
    drawn from the client's stream of the seed, keeps its answers (and has
    the recorder keep their query embeddings) for the check; the others keep
    their times alone. A request's latency runs from its burst's send to the
    burst's answer."""

    def __init__(self, server, texts, traffic: dict, seed: int, recorder):
        self.server, self.texts, self.top_k = server, texts, int(traffic["top_k"])
        self.recorder, self.keep = recorder, float(traffic["check"]["keep_share"])
        self.mix, self.pattern = traffic["mix"], traffic["pattern"]
        self.n, self.burst = int(traffic["clients"]), int(traffic["burst"])
        self.seed = seed
        self.stop = threading.Event()
        self.records = [[] for _ in range(self.n)]
        self.threads = [threading.Thread(target=self._loop, args=(c,), daemon=True)
                        for c in range(self.n)]

    def start(self):
        for t in self.threads:
            t.start()

    def _loop(self, c: int) -> None:
        rng = np.random.default_rng(inputs.derive(self.seed, f"client{c}"))
        k = 0
        while not self.stop.is_set():
            m = int(self.pattern[(c + k) % len(self.pattern)])
            entry = self.mix[m]
            first = (k * self.n + c) * self.burst
            texts = [self.texts(first + j) for j in range(self.burst)]
            k += 1
            keep = rng.random() < self.keep
            if keep:
                self.recorder.wanted.update(texts)
            t_s = time.perf_counter()
            try:
                if self.burst == 1:
                    res = [self.server.search(texts[0], top_k=self.top_k,
                                              metric=entry["metric"],
                                              weights=entry.get("weights"))]
                else:
                    res = self.server.search_many(texts, top_k=self.top_k,
                                                  metric=entry["metric"],
                                                  weights=entry.get("weights"))
                err = None
            except Exception as e:  # counted as failed, never as answered
                res, err = [None] * len(texts), repr(e)
            t_e = time.perf_counter()
            self.records[c].extend((t_s, t_e, t, m, r if keep else None, err)
                                   for t, r in zip(texts, res))

    def join(self, timeout: float) -> int:
        """Stop and wait; returns how many requests never came back."""
        self.stop.set()
        deadline = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return self.burst * sum(t.is_alive() for t in self.threads)


def warm_up(enc, index, texts, traffic: dict, max_batch: int, dim: int, seed: int) -> None:
    """Every shape the window will use: the text tower at batch sizes on
    both sides of each bucket up to the server's largest batch, and each
    metric's sweep at a spread of group sizes."""
    sizes = sorted({1, 2, 8, 9, 32, 33, max_batch})
    g = len(texts) - 1
    for n in sizes:
        enc.encode_texts([texts(g - j) for j in range(n)])
        g -= n
    rng = np.random.default_rng(inputs.derive(seed, "warm"))
    for entry in traffic["mix"]:
        for q in sorted({1, 4, 16, 32, 48, max_batch}):
            queries = rng.standard_normal((q, dim)).astype(np.float32)
            params = entry.get("weights")
            index.search(queries, top_k=int(traffic["top_k"]), metric=entry["metric"],
                         params=params)


def run(ctx) -> Run:
    import torch

    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.config import Config, IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    cuda = str(ctx.device).startswith("cuda")
    model, tr, ix = ctx.config["model"], ctx.traffic, ctx.config["index"]
    n, d, chunk = int(ix["rows"]), int(model["embed_dim"]), int(ix["insert_chunk"])

    weights = inputs.make_weights(model, ctx.seed, ctx.device)
    enc = CLIPEncoder(Config(model=ctx.model_config), params=weights, device=ctx.device)
    del weights
    rows, mags = inputs.make_gallery(n, d, ctx.seed, ctx.device, chunk, ix["magnitude_range"])
    index = ShardedVectorIndex(dim=d, config=IndexConfig(embedding_dim=d, dtype=ix["dtype"],
                                                         capacity_step=n), device=ctx.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        index.insert([inputs.row_path(i) for i in range(lo, hi)], rows[lo:hi],
                     magnitudes=mags[lo:hi])
    server = SearchServer(enc, index)
    profiler = profiling.Profiler(ctx.device) if ctx.trace else None
    recorder = TextRecorder(enc, ctx.trace, profiler)
    enc.encode_texts = recorder
    if ctx.trace:
        enc.tokenizer = TokenizerSpan(enc.tokenizer)
        searches = SearchRecorder(index)
        index.search = searches
    server.start()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)

    texts = inputs.QueryTexts(tr["texts"], ctx.seed)
    warm_up(enc, index, texts, tr, server.max_batch, d, ctx.seed)
    clients = Clients(server, texts, tr, ctx.seed, recorder)
    clients.start()
    time.sleep(float(tr["warmup_s"]))
    stats0 = dict(server.stats)
    t0 = time.perf_counter()
    if profiler is not None:
        start = t0 + 0.35 * ctx.seconds
        profiler.arm(start, min(float(tr["profile_s"]), 0.3 * ctx.seconds))
    time.sleep(max(0.0, t0 + ctx.seconds - time.perf_counter()))
    t1 = time.perf_counter()
    stats1 = dict(server.stats)
    lost = clients.join(timeout=60.0)
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    records = [r for per in clients.records for r in per]
    done = [r for r in records if t0 <= r[1] <= t1]
    answered = [r for r in done if r[5] is None]
    failed = len(done) - len(answered) + lost
    out = Run(attempted=len(done) + lost, failed=failed, answered=len(answered),
              latency_spans=[(r[0], r[1]) for r in answered],
              stats={k: stats1[k] - stats0.get(k, 0) for k in ("requests", "batches", "groups")},
              setup_s=t0 - ctx.t_process, window_s=t1 - t0, memory_peak_bytes=memory_peak)
    sizes = [n for t, n in recorder.calls if t0 <= t <= t1]
    out.notes = [f"window batches {len(sizes)}, texts a batch: mean {np.mean(sizes):.2f}, "
                 f"quartiles {np.percentile(sizes, [25, 50, 75]).tolist()}"] if sizes else []
    tenths = np.histogram([r[1] for r in answered], bins=10, range=(t0, t1))[0]
    out.notes.append(f"answered in each tenth of the window: {tenths.tolist()}")
    if ctx.trace:
        out.encodes = [c for c in recorder.calls if t0 <= c[0] <= t1]
        out.sweeps = [c for c in searches.calls if t0 <= c[0] <= t1]
        out.profiler, out.gallery_rows = profiler, n
        out.trace = profiler.summary(RANGES)

    sample = draw_sample(answered, recorder.count, tr, ctx.seed)
    served = {r[2]: recorder.rows[r[2]] for per in sample for r in per}
    server.stop()
    recorder.fn = None
    del server, index, enc, clients, recorder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out.checks = compare.search_checks(ctx.config, tr, ctx.seed, ctx.device, sample, served,
                                       rows, mags)
    return out


def draw_sample(answered: list, counts: dict, traffic: dict, seed: int) -> list:
    """Per metric of the mix, up to `check.requests_per_metric` requests drawn
    from the seed among those answered in the window that kept their answer
    and whose text the encoder saw once (so the recorded embedding is the one
    the request was served from)."""
    rng = np.random.default_rng(inputs.derive(seed, "check"))
    per = int(traffic["check"]["requests_per_metric"])
    out = []
    for m in range(len(traffic["mix"])):
        pool = [r for r in answered if r[3] == m and r[4] is not None and counts.get(r[2]) == 1]
        pick = rng.choice(len(pool), size=min(per, len(pool)), replace=False) if pool else []
        out.append([pool[int(i)] for i in sorted(pick)])
    return out
