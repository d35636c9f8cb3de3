"""Shared pieces of the benchmark's tests: tiny shapes of each cell that run
on the CPU through the whole harness in a few seconds.

Run: `python -m pytest bench_port/tests -q` (tests marked `gpu` skip without
a card; on the card they run at the cells' sizes)."""

import copy
import os
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from bench_port import harness  # noqa: E402

TINY_MODEL = dict(image_size=32, patch_size=16, vision_width=64, vision_layers=2,
                  vision_heads=2, text_width=64, text_layers=2, text_heads=2,
                  context_length=77, embed_dim=32)


def tiny_config(name: str, rows: int = 4096) -> dict:
    c = copy.deepcopy(harness.data("configs", name))
    c["model"].update(TINY_MODEL)
    c["index"].update(rows=rows, insert_chunk=1024)
    return c


def tiny_traffic(name: str) -> dict:
    tr = copy.deepcopy(harness.data("traffic", name))
    if tr["kind"] == "search":
        tr.update(clients=4, warmup_s=0.3, profile_s=0.2)
        tr["check"].update(requests_per_metric=8, keep_share=0.5)
    else:
        tr.update(batch=8, pool_batches=3, warmup_s=0.3, profile_s=0.2)
        tr["check"]["images"] = 6
    return tr


def run_tiny(workload: str, seed: int = 987654321012, seconds: float = 1.0):
    """One run of `workload` at tiny shapes on the CPU: (result, stderr lines)."""
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], workload, "workload")
    return harness.run_cell(bench, workload, seed, seconds, False, "cpu", time.perf_counter(),
                            config=tiny_config(cell["config"]),
                            traffic=tiny_traffic(cell["traffic"]))


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
