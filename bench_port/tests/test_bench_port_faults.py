"""The whole run at tiny sizes on the CPU, with the program's timed path
broken underneath the harness: each fault must bring `correct` to false,
and the sound path must not."""

import numpy as np
import pytest

from bench_port import harness
from conftest import run_tiny


def _stale():
    """A stand-in that returns the previous call's output: the step that
    leaves its state unchanged."""
    last = {}

    def wrap(fn):
        def inner(self, *a, **kw):
            out = np.array(fn(self, *a, **kw))
            prev = last.get("out")
            last["out"] = out.copy()
            return prev[: len(out)] if prev is not None and len(prev) >= len(out) else out
        return inner
    return wrap


def _half_mean(fn):
    """Half of the batch left out, the mean of the rest in its place."""
    def inner(self, *a, **kw):
        out = np.array(fn(self, *a, **kw))
        if len(out) >= 2:
            h = len(out) // 2
            out[h:] = out[:h].mean(0)
        return out
    return inner


def _patch_encoder(monkeypatch, name, wrap):
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    monkeypatch.setattr(CLIPEncoder, name, wrap(getattr(CLIPEncoder, name)))


def _stream(wrap_batch):
    """encode_stream with each yielded batch of embeddings passed through
    wrap_batch(previous, current)."""
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    orig = CLIPEncoder.encode_stream

    def stream(self, batches):
        prev = None
        for meta, emb in orig(self, batches):
            emb = np.array(emb)
            out = wrap_batch(prev, emb)
            prev = emb
            yield meta, out
    return stream


def _altered_answer(monkeypatch, how):
    from image_retrieval_tpu_torch.index import ShardedVectorIndex

    orig = ShardedVectorIndex.search

    def search(self, *a, **kw):
        vals, idx = orig(self, *a, **kw)
        vals, idx = np.array(vals), np.array(idx)
        how(vals, idx)
        return vals, idx
    monkeypatch.setattr(ShardedVectorIndex, "search", search)


def _swap(vals, idx):
    idx[:, [0, 5]] = idx[:, [5, 0]]


def _nudge(vals, idx):
    vals[:, 3] += 1e-3


def _skip_best(vals, idx):
    idx[:, :-1] = idx[:, 1:].copy()
    vals[:, :-1] = vals[:, 1:].copy()


_BENCH = harness.load_benchmark()
SEARCH = tuple(w["name"] for w in _BENCH["workloads"]
               if harness.data("traffic", w["traffic"])["kind"] == "search")
INGEST = tuple(w["name"] for w in _BENCH["workloads"]
               if harness.data("traffic", w["traffic"])["kind"] == "ingest")


@pytest.mark.parametrize("workload", SEARCH + INGEST)
def test_the_sound_path_is_correct(workload):
    assert run_tiny(workload)[0]["correct"]


@pytest.mark.parametrize("workload", SEARCH)
@pytest.mark.parametrize("fault", ["stale", "half_mean"])
def test_a_broken_text_tower_is_not_correct(monkeypatch, workload, fault):
    _patch_encoder(monkeypatch, "encode_texts", _stale() if fault == "stale" else _half_mean)
    result, lines = run_tiny(workload)
    assert not result["correct"]
    assert result["checks"]["text_emb_err"]["value"] > result["checks"]["text_emb_err"]["limit"]


@pytest.mark.parametrize("workload", SEARCH)
@pytest.mark.parametrize("how", [_swap, _nudge, _skip_best])
def test_an_altered_answer_is_not_correct(monkeypatch, workload, how):
    _altered_answer(monkeypatch, how)
    result, _ = run_tiny(workload)
    assert not result["correct"]


@pytest.mark.parametrize("workload", INGEST)
@pytest.mark.parametrize("fault", ["stale", "half_mean", "altered"])
def test_a_broken_image_tower_is_not_correct(monkeypatch, workload, fault):
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    def stale(prev, cur):
        return prev if prev is not None else cur

    def half_mean(prev, cur):
        out = cur.copy()
        out[len(out) // 2:] = out[: len(out) // 2].mean(0)
        return out

    def altered(prev, cur):
        out = cur.copy()
        out[:, 0] += 0.1 * np.linalg.norm(out, axis=1)
        return out

    monkeypatch.setattr(CLIPEncoder, "encode_stream",
                        _stream({"stale": stale, "half_mean": half_mean,
                                 "altered": altered}[fault]))
    result, _ = run_tiny(workload)
    assert not result["correct"]
    assert result["checks"]["image_emb_err"]["value"] > result["checks"]["image_emb_err"]["limit"]
