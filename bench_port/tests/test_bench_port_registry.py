"""The harness finds every configuration, traffic mix, cell and metric by the
name BENCHMARK.json gives it; a new one is a new file, and no file that is
there needs an edit."""

import json
import math
import os
import shutil

import pytest

from bench_port import harness
from conftest import run_tiny, tiny_config

BENCH = harness.load_benchmark()


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(harness.REPO, c["file"]))
        assert harness.data("configs", c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        tr = harness.data("traffic", w["traffic"])
        harness.module("drivers", tr["kind"])
        assert harness.data("cells", w["name"])["limits"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.module("metrics", m["name"]).read)


def test_the_contract_shape_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"] and BENCH["command"][1] == "bench_port/run.py"
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert harness.applies(moved, w)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_a_new_cell_metric_and_mix_are_files_found_by_name(tmp_path, monkeypatch):
    """A copy of bench_port gains a configuration, a traffic mix, a cell's
    limits and a per-layer metric as new files, and runs: nothing that was
    there is edited."""
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in _files(root / "bench_port")}
    bp = root / "bench_port"
    cfg = tiny_config("clip-vit-b32-serving", rows=2048)
    cfg["name"] = "tiny-new"
    (bp / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    tr = harness.data("traffic", "search-cosine-64x1")
    tr.update(clients=2, burst=3, warmup_s=0.2, profile_s=0.1, top_k=5)
    tr["check"].update(requests_per_metric=4, keep_share=0.5)
    (bp / "traffic" / "search-new.json").write_text(json.dumps(tr))
    (bp / "cells" / "tiny-new-search.json").write_text(json.dumps(
        {"limits": {"text_emb_err": 1e-3, "score_err.cosine": 1e-5, "rank_gap.cosine": 1e-5}}))
    (bp / "metrics" / "requests_per_group.py").write_text(
        "def read(run):\n    return run.stats['requests'] / max(run.stats['groups'], 1)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-new", "source": "x", "file": "bench_port/configs/tiny-new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny-new-search", "config": "tiny-new",
                               "traffic": "search-new", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append("tiny-new-search")
    bench["end_to_end"].append({"name": "requests_per_group", "unit": "requests",
                                "better": "higher", "bound": 0.05, "source": "program_counter",
                                "workloads": ["tiny-new-search"]})
    monkeypatch.setattr(harness, "HERE", str(bp))
    result, _ = harness.run_cell(bench, "tiny-new-search", 3, 0.8, False, "cpu", 0.0)
    assert result["correct"], result
    assert set(result["metrics"]) == {"search_qps", "setup_s",
                                      "requests_per_group"}
    assert all(open(p, "rb").read() == b for p, b in before.items())


def _files(d):
    return [os.path.join(a, f) for a, _, fs in os.walk(d) for f in fs
            if "__pycache__" not in a]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_runs_whole_at_tiny_size(workload):
    result, lines = run_tiny(workload)
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] > 0
    want = {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, workload)}
    assert set(result["metrics"]) == want
    assert all(math.isfinite(v["value"]) and v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert lines[-1].startswith("check attempted")
    for name, c in result["checks"].items():
        assert any(line.startswith(f"check {name}:") for line in lines)
        assert c["value"] <= c["limit"]
