"""The port's tracing helpers (utils/profiling.py), the counterpart of
tests/test_profiling.py: stage times, named ranges seen by torch.profiler,
a trace file written by profile_to, the throughput counter; and the ranges
the search and embed paths open."""

import os

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from image_retrieval_tpu_torch.utils.profiling import StageTimes, Throughput, profile_to, trace


def _range_names(prof):
    return {e.key for e in prof.key_averages()}


def test_trace_and_stage_times():
    st = StageTimes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with st.stage("embed"):
            np.ones((100, 100)) @ np.ones((100, 100))
        with st.stage("search"):
            pass
        with trace("standalone", device="cpu"):
            torch.ones(4) + 1
    s = st.summary()
    assert set(s) == {"embed", "search"}
    assert s["embed"] >= 0
    assert {"embed", "search", "standalone"} <= _range_names(prof)


def test_throughput_counter():
    t = Throughput("ingest")
    t.add(100)
    t.add(50)
    assert t.items == 150
    assert t.per_sec > 0
    t.log()


def test_profile_to_writes_a_trace(tmp_path):
    with profile_to(str(tmp_path)):
        with trace("search/encode_text"):
            torch.ones(8) * 2
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files
    with open(tmp_path / files[0]) as f:
        assert "search/encode_text" in f.read()
    with profile_to(None):  # no directory: a no-op
        pass


def test_search_and_embed_open_their_ranges(tmp_path):
    from PIL import Image

    from image_retrieval_tpu_torch.app.embed import ImageEmbeddingSystem
    from image_retrieval_tpu_torch.app.search import TextImageSearcher
    from image_retrieval_tpu_torch.models.encoder import FakeEncoder

    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)).save(paths[-1])
    enc = FakeEncoder(dim=16)
    system = ImageEmbeddingSystem(enc, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        system.process_and_store_images(paths)
        searcher = TextImageSearcher(enc, system.index)
        searcher.search("a thing", top_k=2, score_threshold=-1.0)
        searcher.search_by_image(paths[0], top_k=2, score_threshold=-1.0)
    assert {"embed/index_insert", "search/encode_text",
            "search/encode_image"} <= _range_names(prof)
