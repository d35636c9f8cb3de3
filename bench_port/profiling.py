"""The traced run's profiler and the reduction of its trace to numbers.

torch.profiler records the host ranges (record_function) of the thread
that enables it, and no other: so `Profiler.poll` is called by the thread
that launches the device work (the server's loop thread in a search cell,
the ingest loop in an ingest cell), at its step boundaries, and opens and
closes the profiler there. Kernels are the card's, whichever thread
launched them; each is attributed to the harness range that was open on
its launching thread when it was launched (through the launch's
correlation id).

The trace is written under TMPDIR, read back and deleted: nothing of it is
kept but the numbers.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from contextlib import nullcontext

WINDOW_RANGE = "bench.profiled_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# a window that opens as the work starts loses kernel records now and then:
# the profiler gets this long to settle first
SETTLE_S = 0.02


def span(enabled: bool, name: str):
    """A record_function range named `name` in a traced run, else nothing."""
    if not enabled:
        return nullcontext()
    import torch

    return torch.profiler.record_function(name)


class Profiler:
    """torch.profiler over `seconds` of the host clock from `start_at` on,
    opened and closed by `poll` in the working thread. Made in set-up, it
    opens and closes the profiler once there, so that the profiling library's
    first start (a second or more) is set-up and not window."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self.start_at = self.seconds = None
        self.t_start = self.t_stop = None
        self.state = "idle"
        self._prof = self._mark = None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            pass

    def arm(self, start_at: float, seconds: float) -> None:
        self.start_at, self.seconds = start_at, seconds
        self.state = "armed"

    def poll(self) -> None:
        if self.state not in ("armed", "on"):
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        now = time.perf_counter()
        if self.state == "armed" and now >= self.start_at:
            torch.cuda.synchronize(self.device)
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.start()
            time.sleep(SETTLE_S)
            self._mark = torch.profiler.record_function(WINDOW_RANGE)
            self._mark.__enter__()
            self.t_start = time.perf_counter()
            self.state = "on"
        elif self.state == "on" and now >= self.t_start + self.seconds:
            torch.cuda.synchronize(self.device)
            self.t_stop = time.perf_counter()
            self._mark.__exit__(None, None, None)
            self._prof.stop()
            self.state = "done"

    def inside(self, t: float) -> bool:
        """Whether host time `t` fell inside the profiled window."""
        return self.t_start is not None and self.t_start <= t <= (self.t_stop or t)

    def summary(self, ranges) -> "TraceSummary":
        """Export the trace under TMPDIR, reduce it, delete it."""
        if self.state != "done":
            raise RuntimeError(f"the profiled window never closed (state {self.state})")
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return reduce_trace(events, ranges)


def idle_pct(trace: "TraceSummary"):
    """The share of the profiled window in which no kernel, copy or memset ran
    on the card, or None for an empty window."""
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


class TraceSummary:
    """What a traced run reads from its trace: `window_s` (the profiled
    window), `busy_s` (the time in it in which a kernel, copy or memset ran
    on the device), `range_s` (device seconds of the kernels, not the copies,
    launched under each harness range), `device_ops` and `idle_gaps` ([name, seconds],
    longest first)."""

    def __init__(self, window_s, busy_s, range_s, device_ops, idle_gaps):
        self.window_s, self.busy_s, self.range_s = window_s, busy_s, range_s
        self.device_ops, self.idle_gaps = device_ops, idle_gaps


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events: list, ranges) -> TraceSummary:
    """Reduce a chrome trace's events to a TraceSummary. `ranges` are the
    harness range names whose kernels are summed; idle time is named by the
    innermost of them open on the working thread (the thread of the
    profiled-window range), or "outside the harness ranges"."""
    window = [e for e in events if e.get("name") == WINDOW_RANGE
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no profiled-window range")
    w = window[0]
    w0, w1, wtid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w.get("tid")
    launches, spans, device = {}, [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
        elif cat == "user_annotation" and e.get("name") in ranges:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"),
                          e["name"]))
        elif cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                           e.get("name", cat), args.get("correlation"), cat))
    by_tid = {}
    for s in spans:
        by_tid.setdefault(s[2], []).append(s)
    for lst in by_tid.values():
        lst.sort()

    heads = {tid: [s[0] for s in lst] for tid, lst in by_tid.items()}

    def open_range(t, tid):
        """The innermost range open at host time t on thread tid: the latest
        started of those that hold t (ranges nest at most a few deep)."""
        lst = by_tid.get(tid, ())
        i = bisect.bisect_right(heads.get(tid, ()), t) - 1
        for j in range(i, max(i - 8, -1), -1):
            if lst[j][1] >= t:
                return lst[j][3]
        return None

    range_s = {name: 0.0 for name in ranges}
    ops, kept = {}, []
    for a, b, name, corr, cat in device:
        if b < w0 or a > w1:
            continue
        kept.append((max(a, w0), min(b, w1)))
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
        launch = launches.get(corr)
        owner = open_range(launch[0], launch[1]) if launch else None
        if owner is not None and cat == "kernel":
            range_s[owner] += (b - a) * 1e-6
    busy = _union(kept)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, prev = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            state = open_range((prev + a) / 2, wtid) or "outside the harness ranges"
            gaps[state] = gaps.get(state, 0.0) + (a - prev) * 1e-6
        prev = max(prev, b)
    top = lambda d: sorted(([k[:160], v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]
    return TraceSummary((w1 - w0) * 1e-6, busy_s, range_s, top(ops), top(gaps))
