"""embed_mfu_pct: the whole ingest step's share of the card's peak: the images
embedded in the window times the image tower's operations at each type's
peak, over the window's seconds."""

from bench_port import bounds


def read(run):
    per = bounds.seconds_at_peak(bounds.tower_work(run.config["model"], "vision", 1))
    return 100.0 * run.images * per / run.window_s
