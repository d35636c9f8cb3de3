"""search_mfu_pct: the whole micro-batch step's share of the card's peak: over
the window, the text tower's operations for the real queries and every
group's sweep products, each at the peak of the type it runs in, over the
window's seconds."""

from bench_port import bounds


def read(run):
    if not run.encodes:
        return None
    model = run.config["model"]
    tier = run.config["index"]["dtype"]
    need = sum(bounds.seconds_at_peak(bounds.tower_work(model, "text", n))
               for _, n in run.encodes)
    for _, q, metric, params in run.sweeps:
        w = None if metric == "cosine_similarity" else bounds.wtuple(params)
        need += bounds.seconds_at_peak(
            bounds.sweep_work(tier, w, q, run.gallery_rows, model["embed_dim"]))
    return 100.0 * need / run.window_s
