"""The numbers that decide `correct`: what the timed path produced against
the plain reference, each held to a limit of `bench_port/cells/<cell>.json`.

Search cells:

- `text_emb_err`: over the sampled requests, the largest relative L2 error
  ||e - e_ref|| / ||e_ref|| of the query embedding the program's text tower
  produced against the reference's, which tokenizes the text itself;
- `score_err.<mix>`: the largest error of a served score against the
  float64 score of the served row, from the program's query embedding
  (relative to |score| where that is above 1);
- `rank_gap.<mix>`: the largest amount by which the reference's score of the
  served row at rank r lies below the reference's r-th best over the whole
  gallery (relative as above). A short answer, a path the gallery does not
  hold or a row served twice reads inf.

Ingest cells:

- `image_emb_err`: over the sampled images, every embedding the program
  returned for them in the run, the largest relative L2 error against the
  reference's embedding of the same pixels (inf where one never came).

The sweep is checked from the program's own query embeddings, so the text
tower's stage and the sweep's are held each by its own number.
"""

from __future__ import annotations

import math

import numpy as np

from bench_port import inputs

CHUNK = 32


def rel_err(got, want) -> np.ndarray:
    """||got - want|| / ||want|| along the last axis."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want, axis=-1) / np.maximum(np.linalg.norm(want, axis=-1),
                                                            1e-30)


def text_embeddings(model: dict, weights: dict, texts: list, device, levels=None):
    """The reference's text-tower embeddings of `texts` ((S, E) float64 numpy)."""
    import torch

    from bench_port.reference.clip import INT8, CLIPReference, full_f32
    from bench_port.reference.tokenizer import fixture_tokenizer

    ids = fixture_tokenizer()(texts, model["context_length"]).astype(np.int64)
    with full_f32():
        ref = CLIPReference(model, weights, levels or INT8, towers=("text",))
        out = [ref.encode_tokens(torch.from_numpy(ids[i: i + CHUNK]).to(device))
               for i in range(0, len(texts), CHUNK)]
    return torch.cat(out).double().cpu().numpy() if out else np.zeros((0, model["embed_dim"]))


def image_embeddings(model: dict, weights: dict, pixels: np.ndarray, device, levels=None):
    """The reference's image-tower embeddings of uint8 `pixels`."""
    import torch

    from bench_port.reference.clip import INT8, CLIPReference, full_f32

    with full_f32():
        ref = CLIPReference(model, weights, levels or INT8, towers=("vision",))
        out = [ref.encode_u8(torch.from_numpy(pixels[i: i + CHUNK]).to(device))
               for i in range(0, len(pixels), CHUNK)]
    return torch.cat(out).double().cpu().numpy()


def answer_numbers(scorer, embs: np.ndarray, answers: list, rows: np.ndarray,
                   mags: np.ndarray, k: int, device) -> tuple:
    """(score_err, rank_gap) of served `answers` ([{'path', 'score'}] each)
    for the queries `embs` against the reference `scorer`."""
    import torch

    from bench_port.reference.search import exact_scores, reference_topk

    if not answers:
        return math.inf, math.inf
    q = torch.from_numpy(np.asarray(embs, np.float32)).to(device)
    ref_v, _ = reference_topk(scorer, q, rows, mags, k, device)
    serr = gap = 0.0
    for j, hits in enumerate(answers):
        ids = np.array([inputs.path_row(h["path"]) for h in hits], np.int64)
        if (len(hits) < k or (ids < 0).any() or (ids >= rows.shape[0]).any()
                or len(set(ids.tolist())) < len(ids)):
            return math.inf, math.inf
        ex = exact_scores(scorer, q[j], rows, mags, ids, device)
        got = np.array([h["score"] for h in hits], np.float64)
        if not np.isfinite(got).all():
            return math.inf, math.inf
        serr = max(serr, float(np.max(np.abs(got - ex) / np.maximum(1.0, np.abs(ex)))))
        gap = max(gap, float(np.max((ref_v[j] - ex) / np.maximum(1.0, np.abs(ref_v[j])))))
    return serr, gap


def search_checks(config: dict, traffic: dict, seed: int, device, sample: list,
                  served: dict, rows: np.ndarray, mags: np.ndarray) -> dict:
    """The search cell's numbers. `sample` holds, per entry of the traffic's
    mix, the sampled request records (t_sent, t_done, text, mix, answer,
    error); `served` maps each sampled text to the embedding the program's
    text tower produced for it."""
    from bench_port.bounds import wtuple
    from bench_port.reference.search import Scorer

    model, k = config["model"], int(traffic["top_k"])
    weights = inputs.make_weights(model, seed, device)
    texts = [r[2] for per in sample for r in per]
    prog = np.stack([served[t] for t in texts]) if texts else np.zeros((0, model["embed_dim"]))
    ref = text_embeddings(model, weights, texts, device)
    del weights
    out = {"text_emb_err": float(rel_err(prog, ref).max()) if texts else math.inf}
    tier = config["index"]["dtype"]
    for m, per in enumerate(sample):
        entry = traffic["mix"][m]
        w = entry.get("weights")
        scorer = Scorer(tier, entry["metric"], wtuple(w) if w else None)
        embs = np.stack([served[r[2]] for r in per]) if per else np.zeros((0, model["embed_dim"]))
        serr, gap = answer_numbers(scorer, embs, [r[4] for r in per], rows, mags, k, device)
        out[f"score_err.{entry['name']}"] = serr
        out[f"rank_gap.{entry['name']}"] = gap
    return out


def image_checks(config: dict, seed: int, device, pixels: np.ndarray, outputs: list) -> dict:
    """The ingest cell's number: `pixels` the sampled images, `outputs[i]` every
    embedding the program returned for image i."""
    model = config["model"]
    weights = inputs.make_weights(model, seed, device)
    ref = image_embeddings(model, weights, pixels, device)
    worst = 0.0
    for i, outs in enumerate(outputs):
        if not outs:
            return {"image_emb_err": math.inf}
        worst = max(worst, float(rel_err(np.stack(outs), ref[i][None]).max()))
    return {"image_emb_err": worst}
