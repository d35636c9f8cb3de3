"""One-command pretrained-checkpoint validation, the port's counterpart of
the JAX package's ``tools/validate_pretrained.py`` (same flags, exit codes
and log lines), kept in the package so that an installed port finds it:

    python -m image_retrieval_tpu_torch.app.validate_pretrained <checkpoint_dir> \\
        --coco-dir <images> --annotation-file <instances.json> \\
        [--reference-results <results.json>] [--output-dir <dir>]

or, with an already-built color dataset (metadata.csv + pairs.json):

    python -m image_retrieval_tpu_torch.app.validate_pretrained <checkpoint_dir> \\
        --dataset-dir <dir>

or on a synthetic dataset (``--synthetic``).

Chain (reference color_analysis_workflow.py:35-195 stages):
  1. PORT    — model config read from the checkpoint's config.json
               (models/weights.py model_config_from_hf), weights ported
               (load_hf_clip_params), tokenizer vocab/merges loaded from the
               checkpoint and probe-tokenized; --check-serving then holds
               the serving tower (serving_config: whole-layer int8 kernels)
               against the plain tower on the ported weights.
  2. EMBED   — batched encode of every dataset image, on the card.
  3. ANALYZE — full MI analysis -> results.json (+ plots where matplotlib is
               installed).
  4. DIFF    — per-metric delta table vs a reference results.json
               (general_mi / color_mi / optimal_weights), when one is given.

Exit code 0 iff every compared value is within --atol (default 5e-3 bits —
binning is discontinuous, so exact digit parity is only expected when the
embeddings themselves are identical). --report-only always exits 0; 2 when
the workflow produced no results.json. The JAX tool's --reference-results
defaults to the reference tree's results.json; here there is no default,
and without the flag the diff is skipped, as the JAX tool skips it where
that file is absent.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from image_retrieval_tpu_torch.device import DeviceLike

logger = logging.getLogger("validate_pretrained")


def _port_and_check(ckpt: str):
    """Step 1: port weights + tokenizer; returns a ready Config."""
    from image_retrieval_tpu_torch.config import Config
    from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer
    from image_retrieval_tpu_torch.models.weights import (
        load_hf_clip_params,
        model_config_from_hf,
    )

    mcfg = model_config_from_hf(ckpt)
    logger.info(
        "checkpoint config: vision %dx%d/%d w%d L%d, text w%d L%d, "
        "vocab %d, embed %d",
        mcfg.image_size, mcfg.image_size, mcfg.patch_size, mcfg.vision_width,
        mcfg.vision_layers, mcfg.text_width, mcfg.text_layers,
        mcfg.vocab_size, mcfg.embed_dim,
    )
    params = load_hf_clip_params(ckpt, mcfg)  # raises on layout mismatch
    n_params = sum(v.numel() for v in params.values())
    logger.info("ported %d parameters (%.1f M)", n_params, n_params / 1e6)

    vocab_file = os.path.join(ckpt, "vocab.json")
    merges_file = os.path.join(ckpt, "merges.txt")
    if not (os.path.exists(vocab_file) and os.path.exists(merges_file)):
        raise FileNotFoundError(
            f"checkpoint dir {ckpt} lacks vocab.json/merges.txt — the text "
            "tower would silently tokenize with the test fixture vocab"
        )
    tok = get_tokenizer(ckpt)
    ids = tok.encode("a photo of a brown dog")
    if len(ids) < 3:
        raise ValueError("tokenizer probe produced a degenerate encoding")
    logger.info("tokenizer ok: vocab loaded from checkpoint, probe -> %d ids",
                len(ids))
    return Config(model=mcfg, weights_path=ckpt)


def _check_serving(config, n: int = 4, threshold: float = 0.98, *,
                   device: DeviceLike = "cuda") -> float:
    """Optional step 1b: the serving tower (whole-layer int8 kernels,
    config.serving_config) must agree with the plain tower ON THE PORTED
    WEIGHTS — the kernels are held to their plain versions on random
    weights, but real checkpoints have other activation statistics, so the
    validation re-checks on the actual weights. Returns the worst image/text
    row cosine; raises below `threshold`."""
    import dataclasses

    import numpy as np

    from image_retrieval_tpu_torch.config import serving_config
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    enc = CLIPEncoder(config, device=device)
    scfg = dataclasses.replace(config, model=serving_config(config.model))
    senc = CLIPEncoder(scfg, params=enc.model.state_dict(), device=device)
    rng = np.random.default_rng(0)
    size = config.model.image_size
    px = rng.uniform(0.0, 1.0, (n, size, size, 3)).astype(np.float32)
    texts = ["a photo of a brown dog", "blue car on a road"][:n]

    def worst_cos(a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        num = (a * b).sum(1)
        den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
        return float((num / np.where(den > 0, den, 1.0)).min())

    ci = worst_cos(enc.encode_pixels(px), senc.encode_pixels(px))
    ct = worst_cos(enc.encode_texts(texts), senc.encode_texts(texts))
    worst = min(ci, ct)
    logger.info("serving-tower consistency on ported weights: "
                "image cos >= %.5f, text cos >= %.5f", ci, ct)
    if worst < threshold:
        raise ValueError(
            f"serving tower diverges from the parity tower on these weights "
            f"(worst cosine {worst:.4f} < {threshold}); serve with the "
            "default (parity) config for this checkpoint"
        )
    return worst


def _diff_table(ours: dict, ref: dict, atol: float):
    """Print per-metric deltas; return the worst absolute delta."""
    worst = 0.0
    rows = []
    for section in ("general_mi", "color_mi"):
        for metric in sorted(set(ref.get(section, {})) | set(ours.get(section, {}))):
            want = ref.get(section, {}).get(metric)
            got = ours.get(section, {}).get(metric)
            if want is None or got is None:
                rows.append((f"{section}.{metric}", want, got, float("inf")))
                worst = float("inf")
                continue
            d = abs(got - want)
            worst = max(worst, d)
            rows.append((f"{section}.{metric}", want, got, d))
    for key in sorted(set(ref.get("optimal_weights", {}))
                      | set(ours.get("optimal_weights", {}))):
        want = ref.get("optimal_weights", {}).get(key)
        got = ours.get("optimal_weights", {}).get(key)
        d = (abs(got - want) if (want is not None and got is not None)
             else float("inf"))
        worst = max(worst, d)
        rows.append((f"optimal_weights.{key}", want, got, d))

    name_w = max(len(r[0]) for r in rows)
    print(f"\n{'metric':<{name_w}}  {'reference':>12}  {'ours':>12}  "
          f"{'|delta|':>10}  ok")
    print("-" * (name_w + 44))
    for name, want, got, d in rows:
        ws = "missing" if want is None else f"{want:.6f}"
        gs = "missing" if got is None else f"{got:.6f}"
        ok = "yes" if d <= atol else "NO"
        print(f"{name:<{name_w}}  {ws:>12}  {gs:>12}  {d:>10.2e}  {ok}")
    print(f"\nworst |delta| = {worst:.3e}  (atol {atol:g})")
    return worst


def main(argv=None, *, device: DeviceLike = "cuda"):
    """The command line; `device` (a keyword for callers, the card by
    default) runs the encoders and the analysis."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint_dir",
                    help="HF CLIP checkpoint dir (model.safetensors or "
                         "pytorch_model.bin + config.json + vocab/merges)")
    ap.add_argument("--dataset-dir",
                    help="existing color dataset dir (metadata.csv/pairs.json)")
    ap.add_argument("--coco-dir", help="COCO images (builds the dataset)")
    ap.add_argument("--annotation-file", help="COCO instances annotation json")
    ap.add_argument("--synthetic", action="store_true",
                    help="build the dataset synthetically (no COCO needed)")
    ap.add_argument("--output-dir", default="pretrained_validation")
    ap.add_argument("--reference-results", default=None,
                    help="results.json to diff against (no diff without it)")
    ap.add_argument("--atol", type=float, default=5e-3,
                    help="per-value tolerance in bits/weight units")
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--report-only", action="store_true",
                    help="print the diff table but always exit 0")
    ap.add_argument("--check-serving", action="store_true",
                    help="also verify the serving tower (int8 layer kernels) "
                         "agrees with the plain tower on the ported weights")
    args = ap.parse_args(argv)

    if not (args.dataset_dir or args.synthetic
            or (args.coco_dir and args.annotation_file)):
        ap.error("provide --dataset-dir, --synthetic, or "
                 "--coco-dir + --annotation-file")

    config = _port_and_check(args.checkpoint_dir)
    if args.check_serving:
        _check_serving(config, device=device)

    os.makedirs(args.output_dir, exist_ok=True)

    from image_retrieval_tpu_torch.app.workflow import run_workflow

    results = run_workflow(
        coco_dir=args.coco_dir,
        annotation_file=args.annotation_file,
        output_dir=args.output_dir,
        synthetic=args.synthetic,
        batch_size=args.batch_size,
        config=config,
        dataset_dir=os.path.abspath(args.dataset_dir) if args.dataset_dir else None,
        device=device,
    )
    if results is None:
        logger.error("workflow failed — no results.json produced")
        return 2

    if not args.reference_results or not os.path.exists(args.reference_results):
        logger.warning("reference results %s not found; skipping diff",
                       args.reference_results)
        return 0
    with open(args.reference_results, encoding="utf-8") as f:
        ref = json.load(f)
    worst = _diff_table(results, ref, args.atol)
    if args.report_only:
        return 0
    return 0 if worst <= args.atol else 1


if __name__ == "__main__":
    sys.exit(main())
