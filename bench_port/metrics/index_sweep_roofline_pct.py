"""index_sweep_roofline_pct: each group's sweep bound (bounds.sweep_bound: the
gallery's bytes read once or the tier's operations at their peaks, whichever
is larger) over the device time of the kernels launched under the harness's
index.search range, in the profiled window."""

from bench_port import bounds


def _weights(params):
    return None if params is None else bounds.wtuple(params)


def read(run):
    dev_s = run.trace.range_s.get("index.search", 0.0)
    calls = [c for c in run.sweeps if run.profiler.inside(c[0])]
    if dev_s <= 0 or not calls:
        return None
    tier = run.config["index"]["dtype"]
    d = run.config["model"]["embed_dim"]
    need = 0.0
    for _, q, metric, params in calls:
        w = None if metric == "cosine_similarity" else _weights(params)
        need += bounds.sweep_bound(tier, w, q, run.gallery_rows, d)["bound_ms"] * 1e-3
    return 100.0 * need / dev_s
