"""Headless end-to-end color-analysis workflow — port of
``image_retrieval_tpu/app/workflow.py``.

Mirrors reference color_analysis_workflow.py:35-195 (same stages, same flag
names, same artifact layout under --output_dir):

  Step 1  dataset        -> <out>/color_dataset/{metadata.csv,pairs.json,...}
  Step 2  embeddings     -> <out>/color_embeddings.npz    (batched, in flight)
  Step 3  analysis       -> <out>/analysis_results/{results.json, *.png}
  report  sorted color MI, non-zero optimal weights, % improvement

    python -m image_retrieval_tpu_torch.app.workflow --synthetic --output_dir out

Extensions: --synthetic builds the dataset without COCO (the reference
crashes in that case), and --fake_encoder runs the pipeline without CLIP
weights (deterministic, for CI and zero-egress environments). The encoder,
the COCO filter's dominant colors and the analysis run on `device`, the card
unless the caller of run_workflow asks for the CPU (the command line takes
the JAX workflow's flags and runs CLIP on the card; --fake_encoder keeps
the run on the host). A --weights_path checkpoint is loaded
but not validated against the reference forward (the JAX package runs
tools/validate_pretrained.py once per checkpoint; ROADMAP.md lists it).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional

import numpy as np

from image_retrieval_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)


def run_workflow(
    coco_dir: Optional[str] = None,
    annotation_file: Optional[str] = None,
    output_dir: str = "color_analysis",
    skip_dataset: bool = False,
    skip_embeddings: bool = False,
    synthetic: bool = False,
    fake_encoder: bool = False,
    num_examples: int = 5,
    batch_size: int = 100,
    native_decode: bool = False,
    config=None,
    dataset_dir: Optional[str] = None,
    *,
    device: DeviceLike = "cuda",
) -> Optional[dict]:
    """`dataset_dir`: use an existing prepared color dataset at this exact
    path (implies skip_dataset) instead of <output_dir>/color_dataset —
    pairs.json/metadata paths then resolve against the caller's directory,
    not a copy. `device` runs the encoder, the COCO filter's dominant colors
    and the analysis."""
    from image_retrieval_tpu_torch.data.dataset import prepare_color_dataset, read_metadata
    from image_retrieval_tpu_torch.models.encoder import get_encoder

    os.makedirs(output_dir, exist_ok=True)
    if dataset_dir is not None:
        # an EXPLICIT dataset path must exist — falling through to dataset
        # generation at the typo'd location would silently analyze wrong data
        if not os.path.isdir(dataset_dir):
            raise FileNotFoundError(f"dataset_dir '{dataset_dir}' does not exist")
        skip_dataset = True
    else:
        dataset_dir = os.path.join(output_dir, "color_dataset")

    # Step 1: dataset
    if skip_dataset and os.path.exists(dataset_dir):
        logger.info(f"Using existing dataset at {dataset_dir}")
        metadata_path = os.path.join(dataset_dir, "metadata.csv")
        if not os.path.exists(metadata_path):
            logger.warning("Metadata file not found. Cannot proceed.")
            return None
        metadata = read_metadata(metadata_path)
    else:
        logger.info("=== Step 1: Preparing Color Dataset ===")
        pairs, metadata = prepare_color_dataset(
            coco_dir=None if synthetic else coco_dir,
            annotation_file=None if synthetic else annotation_file,
            base_dir=dataset_dir,
            num_examples=num_examples,
            device=device,
        )
        if not metadata:
            logger.error("Failed to create dataset.")
            return None
        logger.info(f"Created color dataset with {len(metadata)} images")

    # Step 2: embeddings (batched — replaces the reference's per-image loop,
    # color_analysis_workflow.py:127-142)
    embeddings_file = os.path.join(output_dir, "color_embeddings.npz")
    if skip_embeddings and os.path.exists(embeddings_file):
        logger.info(f"Using existing embeddings at {embeddings_file}")
    else:
        logger.info("=== Step 2: Generating Embeddings ===")
        encoder = get_encoder(config=config, fake=fake_encoder, device=device)
        all_paths = []
        base_norm = os.path.normpath(dataset_dir)
        for item in metadata:
            # normpath both sides: the dataset builder writes Path-normalized
            # strings, so "./out"-style dataset_dir would fail startswith and
            # double-join every path (all decodes would then fail)
            path = os.path.normpath(item["path"])
            if not os.path.isabs(path) and not path.startswith(base_norm + os.sep):
                path = os.path.join(base_norm, path)
            all_paths.append(path)
        # streaming decode -> encode pipeline (bounded memory, overlapped)
        from image_retrieval_tpu_torch.data.loader import encode_folder

        # native_decode=False keeps PIL bicubic preprocessing (CLIPProcessor
        # parity); the C++ decoder uses bilinear and is for throughput ingest.
        size = config.model.image_size if config is not None else 224
        ok_paths, embs = encode_folder(
            encoder, all_paths, batch_size=batch_size, size=size,
            use_native=native_decode,
        )
        embeddings = {p: e for p, e in zip(ok_paths, embs)}
        # atomic publish: --skip_embeddings trusts bare existence of this
        # file, so a crash mid-savez must not leave a truncated npz behind
        tmp = embeddings_file + ".tmp"
        np.savez(tmp, embeddings=np.array(embeddings, dtype=object))
        os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", embeddings_file)
        logger.info(f"Saved embeddings for {len(embeddings)} images to {embeddings_file}")

    # Step 3: analysis
    logger.info("=== Step 3: Running Geometric Information Theory Analysis ===")
    results_dir = os.path.join(output_dir, "analysis_results")
    from image_retrieval_tpu_torch.app.pipeline import run_color_analysis

    analysis = run_color_analysis(
        embeddings_file=embeddings_file,
        dataset_dir=dataset_dir,
        results_dir=results_dir,
        device=device,
    )
    if isinstance(analysis, dict) and analysis.get("error"):
        # a hard failure must not be reported as "Analysis Complete!"
        logger.error(f"Analysis failed: {analysis['error']}")
        return None

    # Report (reference color_analysis_workflow.py:165-191)
    results_json = os.path.join(results_dir, "results.json")
    results = None
    if os.path.exists(results_json):
        with open(results_json) as f:
            results = json.load(f)
        color_mi = results.get("color_mi", {})
        logger.info("\nColor-specific Mutual Information:")
        for metric, mi in sorted(color_mi.items(), key=lambda x: x[1], reverse=True):
            logger.info(f"  {metric}: {mi:.4f} bits")
        logger.info("\nOptimal weights for similarity function:")
        for param, weight in results.get("optimal_weights", {}).items():
            if weight > 0.01:
                logger.info(f"  {param}: {weight:.2f}")
        if "cosine_distance" in color_mi:
            cosine_mi = color_mi["cosine_distance"]
            best_metric, best_mi = max(color_mi.items(), key=lambda x: x[1])
            improvement = (
                (best_mi - cosine_mi) / cosine_mi * 100 if cosine_mi > 0 else float("inf")
            )
            logger.info(f"\nBest metric: {best_metric} with {best_mi:.4f} bits")
            logger.info(f"Improvement over cosine similarity: {improvement:.1f}%")
    logger.info("=== Analysis Complete! ===")
    return results


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )
    parser = argparse.ArgumentParser(
        description="Color-based analysis of CLIP embeddings (the PyTorch/CUDA port)"
    )
    parser.add_argument("--coco_dir", help="Path to COCO dataset images")
    parser.add_argument("--annotation_file", help="Path to COCO annotations")
    parser.add_argument("--output_dir", default="color_analysis")
    parser.add_argument("--skip_dataset", action="store_true")
    parser.add_argument("--skip_embeddings", action="store_true")
    parser.add_argument("--synthetic", action="store_true",
                        help="Build the dataset synthetically (no COCO needed)")
    parser.add_argument("--fake_encoder", action="store_true",
                        help="Use the deterministic fake encoder (no weights)")
    parser.add_argument("--num_examples", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=100)
    parser.add_argument("--native_decode", action="store_true",
                        help="Use the C++ decoder (bilinear) instead of PIL bicubic")
    parser.add_argument("--weights_path",
                        help="HF CLIP checkpoint directory (model.safetensors"
                             " + vocab.json/merges.txt) to port weights from")
    args = parser.parse_args(argv)
    if not args.synthetic and not (args.coco_dir and args.annotation_file):
        parser.error("provide --coco_dir and --annotation_file, or --synthetic")
    config = None
    if args.weights_path:
        from image_retrieval_tpu_torch.config import Config

        config = Config(weights_path=args.weights_path)
        logger.warning("checkpoint %s is loaded but not validated against the "
                       "reference forward: check the port's embeddings of it "
                       "before trusting results.json", args.weights_path)
    run_workflow(
        coco_dir=args.coco_dir,
        annotation_file=args.annotation_file,
        output_dir=args.output_dir,
        skip_dataset=args.skip_dataset,
        skip_embeddings=args.skip_embeddings,
        synthetic=args.synthetic,
        fake_encoder=args.fake_encoder,
        num_examples=args.num_examples,
        batch_size=args.batch_size,
        native_decode=args.native_decode,
        config=config,
    )


if __name__ == "__main__":
    main()
