"""device_idle_pct.ingest: the share of the profiled window in which no kernel,
copy or memset ran on the card, in an ingest cell (profiling.idle_pct)."""

from bench_port import profiling


def read(run):
    return profiling.idle_pct(run.trace)
