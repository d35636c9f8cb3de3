"""text_tower_roofline_pct: the text tower's operation bound for the real
queries of each encode call in the profiled window (77 tokens each; the
padding to the encoder's bucket is not work), over the device time of the
kernels launched under the harness's encoder.encode_texts range."""

from bench_port import bounds


def read(run):
    dev_s = run.trace.range_s.get("encoder.encode_texts", 0.0)
    calls = [n for t, n in run.encodes if run.profiler.inside(t)]
    if dev_s <= 0 or not calls:
        return None
    model = run.config["model"]
    need = sum(bounds.seconds_at_peak(bounds.tower_work(model, "text", n)) for n in calls)
    return 100.0 * need / dev_s
