"""Tracing and profiling helpers — port of ``image_retrieval_tpu/utils/profiling.py``.

Named ranges around the embed and search steps, a device trace writer and
simple throughput counters. A range is a ``torch.profiler.record_function``
(it shows in a ``torch.profiler`` trace, on the host timeline) and, when the
work runs on a CUDA device, also an NVTX range.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

import torch

from image_retrieval_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def _range(name: str, device: Optional[DeviceLike]):
    """record_function, plus an NVTX range when `device` is a CUDA device."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(name: str, device: Optional[DeviceLike] = None):
    """A named range (see _range) + a wall-clock debug log line."""
    t0 = time.perf_counter()
    with _range(name, device):
        yield
    logger.debug(f"{name}: {(time.perf_counter() - t0) * 1e3:.2f} ms")


@contextlib.contextmanager
def profile_to(log_dir: Optional[str]):
    """Capture a torch.profiler trace (host, and the device when CUDA is
    available) into `log_dir` as a Chrome/TensorBoard trace file; a no-op
    without a directory."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class Throughput:
    """Simple items/sec counter for ingest/search loops."""

    def __init__(self, name: str):
        self.name = name
        self.items = 0
        self.t0 = time.perf_counter()

    def add(self, n: int) -> None:
        self.items += n

    @property
    def per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.items / dt if dt > 0 else 0.0

    def log(self) -> None:
        logger.info(f"{self.name}: {self.items} items, {self.per_sec:.1f}/s")


class StageTimes:
    """Per-stage wall-clock accumulator (embed/search/analyze); each stage
    is also a named range (see trace)."""

    def __init__(self, device: Optional[DeviceLike] = None):
        self.device = device
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with _range(name, self.device):
            yield
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> Dict[str, float]:
        return dict(self.times)
