"""The control of a cell's correctness check: the reference itself, computed one
precision below the configuration's and put in the program's place, must
come out as not correct.

    python3 bench_port/control.py --workload <cell> --seeds 11 12 13

For each seed it makes the run's inputs from that seed (weights, gallery
rows, query texts, pixels), at the cell's own sizes, and prints one JSON line
with the cell's compared numbers for each control:

- `int4_towers`: the towers' projections on the int4 grid (weights and
  activations, absmax / 7) in place of the configuration's int8: read by
  `text_emb_err` (search cells) or `image_emb_err` (ingest cells);
- `lower_sweep` (search cells): the sweep one precision below its tier,
  from the configuration's int8 query embeddings: the f32 tier's product in
  TF32, the int8 tier's rows on the int4 grid; the control's own top-k and
  scores are the served answer, read by `score_err.<mix>` and
  `rank_gap.<mix>`.

The benchmark's runs never run it; its readings set the upper end of each
limit (PERF.md, section 6).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from bench_port import compare, harness, inputs  # noqa: E402
from bench_port.bounds import wtuple  # noqa: E402
from bench_port.reference.clip import INT4  # noqa: E402


def sample_texts(traffic: dict, seed: int, n: int) -> list:
    texts = inputs.QueryTexts(traffic["texts"], seed)
    rng = np.random.default_rng(inputs.derive(seed, "control"))
    return [texts(int(g)) for g in rng.choice(min(len(texts), 1 << 20), n, replace=False)]


def served_answers(scorer, embs: np.ndarray, rows, mags, k: int, device) -> list:
    """The control's own answer: its top-k by its own scores, as a sweep in
    its precision gives them."""
    import torch

    from bench_port.reference.search import sweep_topk

    q = torch.from_numpy(np.asarray(embs, np.float32)).to(device)
    vals, ids = sweep_topk(scorer, q, rows, mags, k, device)
    return [[{"path": inputs.row_path(int(i)), "score": float(v)} for v, i in zip(vr, ir)]
            for vr, ir in zip(vals, ids)]


def search_control(config: dict, traffic: dict, seed: int, device) -> dict:
    from bench_port.reference.search import Scorer

    model, k, tier = config["model"], int(traffic["top_k"]), config["index"]["dtype"]
    per = int(traffic["check"]["requests_per_metric"])
    ix = config["index"]
    weights = inputs.make_weights(model, seed, device)
    texts = sample_texts(traffic, seed, per * len(traffic["mix"]))
    good = compare.text_embeddings(model, weights, texts, device)
    low = compare.text_embeddings(model, weights, texts, device, levels=INT4)
    del weights
    out = {"int4_towers": {"text_emb_err": float(compare.rel_err(low, good).max())},
           "lower_sweep": {}}
    rows, mags = inputs.make_gallery(int(ix["rows"]), int(model["embed_dim"]), seed, device,
                                     int(ix["insert_chunk"]), ix["magnitude_range"])
    for m, entry in enumerate(traffic["mix"]):
        w = wtuple(entry["weights"]) if entry.get("weights") else None
        embs = good[m * per: (m + 1) * per]
        lower = (Scorer(tier, entry["metric"], w, tf32=True) if tier == "float32"
                 else Scorer(tier, entry["metric"], w, levels=INT4))
        answers = served_answers(lower, embs, rows, mags, k, device)
        serr, gap = compare.answer_numbers(Scorer(tier, entry["metric"], w), embs, answers,
                                           rows, mags, k, device)
        out["lower_sweep"][f"score_err.{entry['name']}"] = serr
        out["lower_sweep"][f"rank_gap.{entry['name']}"] = gap
    return out


def ingest_control(config: dict, traffic: dict, seed: int, device) -> dict:
    model = config["model"]
    n = int(traffic["check"]["images"])
    pixels = inputs.make_pixels(1, n, int(model["image_size"]), seed, device)[0]
    weights = inputs.make_weights(model, seed, device)
    good = compare.image_embeddings(model, weights, pixels, device)
    low = compare.image_embeddings(model, weights, pixels, device, levels=INT4)
    return {"int4_towers": {"image_emb_err": float(compare.rel_err(low, good).max())}}


def control(workload: str, seed: int, device, config=None, traffic=None) -> dict:
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], workload, "workload")
    config = config or harness.data("configs", cell["config"])
    traffic = traffic or harness.data("traffic", cell["traffic"])
    fn = search_control if traffic["kind"] == "search" else ingest_control
    return fn(config, traffic, seed, device)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    limits = harness.data("cells", args.workload)["limits"]
    for seed in args.seeds:
        got = control(args.workload, seed, "cuda:0")
        fails = sorted(k for part in got.values() for k, v in part.items() if v > limits[k])
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": got,
                          "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
