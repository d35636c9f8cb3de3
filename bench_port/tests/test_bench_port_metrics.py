"""Per-layer readers that need no card: what they read from a Run."""

from types import SimpleNamespace

import numpy as np

from bench_port import harness

P95 = harness.module("metrics", "search_p95_ms.closed_loop")


def test_closed_loop_p95_is_the_95th_percentile_of_every_answered_request():
    lat = np.linspace(1.0, 100.0, 100)
    spans = [(float(i), float(i) + v / 1e3) for i, v in enumerate(lat)]
    run = SimpleNamespace(latency_spans=spans)
    assert abs(P95.read(run) - np.percentile(lat, 95)) < 1e-6


def test_closed_loop_p95_leaves_out_requests_in_flight_while_profiled():
    # requests every 1 s lasting 0.01 s, and three slow ones overlapping the
    # profiler from its arming (50.0) to its stop (52.5)
    spans = [(float(i), i + 0.01) for i in range(100)]
    spans += [(49.99, 50.5), (51.0, 51.9), (52.4, 53.0)]
    prof = SimpleNamespace(start_at=50.0, t_stop=52.5)
    run = SimpleNamespace(latency_spans=spans, profiler=prof)
    kept = [(s, e) for s, e in spans if e < 50.0 or s > 52.5]
    assert len(kept) == 97
    assert abs(P95.read(run) - 10.0) < 1e-6


def test_closed_loop_p95_reads_nothing_without_answers():
    assert P95.read(SimpleNamespace(latency_spans=[])) is None
