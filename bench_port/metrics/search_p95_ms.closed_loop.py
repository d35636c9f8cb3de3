"""search_p95_ms.closed_loop: the 95th percentile of the latency of the
requests answered in the window of a traced run, each from the client's call
to its answer by the host clock, leaving out every request that was in
flight while the profiler was armed, starting, on or stopping (the profiler
stalls the server's loop). A per-layer reading: in a closed loop of clients
at the server's capacity the tail follows the server's batching from run to
run, too unsteady for a bound (PERF.md, section 2)."""

import numpy as np


def read(run):
    prof = getattr(run, "profiler", None)
    spans = run.latency_spans
    if prof is not None and prof.start_at is not None:
        lo, hi = prof.start_at, prof.t_stop if prof.t_stop is not None else float("inf")
        spans = [(s, e) for s, e in spans if e < lo or s > hi]
    if not spans:
        return None
    return float(np.percentile([(e - s) * 1e3 for s, e in spans], 95))
