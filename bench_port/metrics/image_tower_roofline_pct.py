"""image_tower_roofline_pct: one batch's operation bound through the image
tower, times the batches dispatched in the profiled window, over the device
time of the kernels launched under the harness's encoder.encode_stream
range."""

from bench_port import bounds


def read(run):
    dev_s = run.trace.range_s.get("encoder.encode_stream", 0.0)
    n = sum(1 for t in run.dispatched if run.profiler.inside(t))
    if dev_s <= 0 or not n:
        return None
    per = bounds.seconds_at_peak(bounds.tower_work(run.config["model"], "vision", run.batch))
    return 100.0 * n * per / dev_s
