"""Command-line interface — port of ``image_retrieval_tpu/app/cli.py``.

    python -m image_retrieval_tpu_torch.app.cli search --folder ./photos "a red car"
    python -m image_retrieval_tpu_torch.app.cli search --folder ./photos --image q.jpg
    python -m image_retrieval_tpu_torch.app.cli compare --folder ./photos "a red car"
    python -m image_retrieval_tpu_torch.app.cli serve --folder ./photos
    python -m image_retrieval_tpu_torch.app.cli geometric --folder ./photos --optimize
    python -m image_retrieval_tpu_torch.app.cli analyze --synthetic

Each subcommand but `analyze` and `plan` drives ``ImageSearchApp`` over the
images under --folder: `search` (a text query, or --image for an image
query; --optimized, --filter, --save-grid), `compare` (top-k by cosine, L1
and L2 from one multi-metric pass, and how the lists overlap), `serve` (an
interactive loop over the micro-batching SearchServer), `mi` (the standard
pair MI analysis) and `geometric` (the multi-metric pair MI analysis;
--optimize runs the weight grid search, --apply sets the searcher's
weights, --plot writes a bar chart, with bootstrap intervals under --ci).
`analyze` runs the headless color-analysis workflow (app/workflow.py) with
the JAX CLI's flags. Helpers the reference GUI calls but never defines are
implemented here: interpret_mi_value (main.py:370), and an honest bootstrap
interval (mi_confidence_interval) in place of its fabricated one
(main.py:551-570). --journal-dir makes the index
durable; --fake-encoder uses the deterministic projection encoder (no
weights); --fast-encoder selects vit_b32_serving(), whose layers run the
int8 whole-layer kernel; --approx-select sets IndexConfig.approx_select
(accepted; the answers are exact);
--ann ivf takes the candidates from an IVF over the index (--nlist,
--nprobe; 0 = auto), --ann screen from a projection screen (--screen-dims,
--screen-candidates). `plan` prints the index tier for a corpus size
(index/plan.py). Everything runs on the card unless --device cpu is given
(`analyze` has no --device: its encoder runs on the card, its fake encoder
and analysis on the host). Options take dashes or underscores
(--fake_encoder).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Tuple

import numpy as np

logger = logging.getLogger(__name__)


def interpret_mi_value(mi: float) -> str:
    """Qualitative reading of an MI value (implements the undefined helper
    the reference GUI calls at main.py:370)."""
    if mi <= 0.0:
        return "no dependence detected"
    if mi < 0.01:
        return "negligible dependence"
    if mi < 0.05:
        return "weak dependence"
    if mi < 0.2:
        return "moderate dependence"
    if mi < 0.5:
        return "strong dependence"
    return "very strong dependence"


def mi_confidence_interval(
    values: np.ndarray,
    labels: np.ndarray,
    n_bins: int = 20,
    n_boot: int = 200,
    alpha: float = 0.05,
    seed: int = 0,
) -> Tuple[float, float]:
    """Bootstrap CI for binned MI — replaces the reference GUI's fabricated
    sigma ~ MI/sqrt(1000)*0.1 (main.py:551-570)."""
    from image_retrieval_tpu_torch.ops.mi import mutual_info_from_labels

    rng = np.random.default_rng(seed)
    values = np.asarray(values, float)
    labels = np.asarray(labels)
    n = len(values)
    stats = np.empty(n_boot)
    for b in range(n_boot):
        idx = rng.integers(0, n, n)
        stats[b] = mutual_info_from_labels(values[idx], labels[idx], n_bins)
    lo, hi = np.quantile(stats, [alpha / 2, 1 - alpha / 2])
    return float(lo), float(hi)


def _build_app(args):
    """The app over --folder, its images processed (recovered, cached or
    encoded)."""
    from image_retrieval_tpu_torch.app.pipeline import ImageSearchApp
    from image_retrieval_tpu_torch.models.encoder import get_encoder

    encoder = get_encoder(fake=True) if args.fake_encoder else None
    app = ImageSearchApp(encoder=encoder, journal_dir=args.journal_dir, device=args.device)
    if args.fast_encoder and not args.fake_encoder:
        from image_retrieval_tpu_torch.config import vit_b32_serving

        app.config.model = vit_b32_serving()
    if args.approx_select:
        app.config.index.approx_select = True
    app.config.search.ann = args.ann
    app.config.search.nlist = args.nlist
    app.config.search.nprobe = args.nprobe
    app.config.search.screen_dims = args.screen_dims
    app.config.search.screen_candidates = args.screen_candidates
    paths = app.scan_folders(args.folder)
    if not paths:
        print(f"No images found under {args.folder}", file=sys.stderr)
        sys.exit(1)
    app.process_images(paths)
    return app


def save_results_grid(results, output_path: str, thumb: int = 180) -> str:
    """Contact sheet of search hits: thumbnails with score and file name."""
    from PIL import Image, ImageDraw

    n = max(len(results), 1)
    cols = min(5, n)
    rows = -(-n // cols)
    pad, caption = 8, 18
    sheet = Image.new("RGB", (cols * (thumb + pad) + pad, rows * (thumb + caption + pad) + pad),
                      (245, 245, 245))
    draw = ImageDraw.Draw(sheet)
    for i, r in enumerate(results):
        x = pad + (i % cols) * (thumb + pad)
        y = pad + (i // cols) * (thumb + caption + pad)
        try:
            im = Image.open(r["path"]).convert("RGB")
            im.thumbnail((thumb, thumb))
            sheet.paste(im, (x + (thumb - im.width) // 2, y + (thumb - im.height) // 2))
        except Exception:
            draw.rectangle([x, y, x + thumb, y + thumb], outline=(200, 60, 60))
        draw.text((x, y + thumb + 2), f"{r['score']:.3f} {os.path.basename(r['path'])[:24]}",
                  fill=(30, 30, 30))
    sheet.save(output_path)
    return output_path


def cmd_search(args) -> int:
    if (args.query is None) == (args.image is None):
        print("search: provide exactly one of <query> or --image PATH")
        return 2
    app = _build_app(args)
    if args.image is not None:
        results = app.find_similar_images(args.image, top_k=args.top_k,
                                          use_optimized_similarity=args.optimized,
                                          filter_expr=args.filter)
    else:
        results = app.search_images(args.query, top_k=args.top_k,
                                    use_optimized_similarity=args.optimized,
                                    filter_expr=args.filter)
    for i, r in enumerate(results, 1):
        print(f"{i:3d}. {r['score']:.4f}  {r['path']}")
    if args.save_grid and results:
        save_results_grid(results, args.save_grid)
        print(f"Saved results grid to {args.save_grid}")
    return 0


def cmd_mi(args) -> int:
    app = _build_app(args)
    analyzer, results = app.run_mi_analysis(num_pairs=args.num_pairs, num_bins=args.num_bins)
    if results is None:
        return 1
    print(f"Default MI: {results['default']:.4f} bits "
          f"({interpret_mi_value(results['default'])})")
    if analyzer is not None and analyzer.mi_values:
        for metric, mi in sorted(analyzer.mi_values.items(), key=lambda x: -x[1]):
            print(f"  {metric:16s} {mi:.4f} bits  ({interpret_mi_value(mi)})")
    return 0


def cmd_geometric(args) -> int:
    app = _build_app(args)
    analyzer, results = app.run_enhanced_mi_analysis(
        num_pairs=args.num_pairs, num_bins=args.num_bins, keep_unnormalized=True)
    if results is None:
        return 1
    print("Per-metric MI (enhanced analysis):")
    for metric, mi in sorted(results.items(), key=lambda x: -x[1]):
        print(f"  {metric:16s} {mi:.4f} bits  ({interpret_mi_value(mi)})")
    if args.plot:
        from image_retrieval_tpu_torch.analysis.plots import mi_bar_chart

        ci = None
        if args.ci:
            numeric = np.array([analyzer.label_map.get(l, -1) for l in analyzer.labels])
            # distance_measures covers only the KEPT pairs; select labels
            # by the kept indices (truncation misaligns every label after
            # a dropped pair — pair_mi._pair_matrices docstring)
            kept = analyzer._pair_matrices()[4]
            ci = {}
            for metric, vals in analyzer.distance_measures.items():
                v = np.array(vals)
                labels_v = (numeric[kept[: len(v)]] if len(kept) >= len(v)
                            else numeric[: len(v)])
                ci[metric] = mi_confidence_interval(v, labels_v, n_bins=args.num_bins)
        mi_bar_chart(results, args.plot, ci=ci,
                     title="Geometric MI Analysis (bootstrap 95% CI)" if ci
                     else "Geometric MI Analysis")
        print(f"Saved bar chart to {args.plot}")
    if args.optimize:
        grid = np.linspace(0, 1, args.grid_size)
        res = analyzer.find_optimal_parameters(
            {k: grid for k in ("w_angle", "w_l1", "w_l2", "w_inf", "w_mag")})
        print(f"Optimal parameters (MI={res['mi_value']:.4f}):")
        for k, v in res["parameters"].items():
            print(f"  {k} = {v:.2f}")
        if args.apply:
            app.searcher.set_similarity_params(res["parameters"])
            print("Applied optimal parameters to searcher.")
    return 0


def cmd_compare(args) -> int:
    app = _build_app(args)
    results = app.search_with_multiple_metrics(args.query, top_k=args.top_k)
    for metric in ("cosine_similarity", "l1_distance", "l2_distance"):
        if metric in results:
            print(f"\n== {metric} ==")
            for i, r in enumerate(results[metric], 1):
                print(f"{i:3d}. {r['score']:+.4f}  {r['path']}")
    analysis = results.get("analysis", {})
    print("\n== intersections ==")
    for k, v in analysis.get("intersections", {}).items():
        print(f"  {k}: {v['intersection_size']} ({v['intersection_ratio']:.0%})")
    print("== unique contributions ==")
    for k, v in analysis.get("unique_contributions", {}).items():
        print(f"  {k}: {v['unique_count']} ({v['unique_ratio']:.0%})")
    return 0


def cmd_serve(args) -> int:
    """Interactive serving loop over the micro-batching SearchServer."""
    from image_retrieval_tpu_torch.app.server import SearchServer

    app = _build_app(args)
    index = app._ensure_index()
    if index is None or len(index) == 0:
        print("No images produced any embeddings - nothing to serve.")
        return 1
    with SearchServer(app._get_encoder(), index, max_batch=args.max_batch,
                      ann=app._ensure_ann(index),
                      overfetch=app.config.search.overfetch) as server:
        print(f"Serving {len(index)} vectors. Enter queries (blank line to exit).")
        while True:
            try:
                line = input("query> ").strip()
            except EOFError:
                break
            if not line:
                break
            for i, r in enumerate(server.search(line, top_k=args.top_k), 1):
                print(f"{i:3d}. {r['score']:.4f}  {r['path']}")
        print(f"stats: {server.stats}")
    return 0


def cmd_plan(args) -> int:
    """Print the index tier plan_index picks for a corpus size."""
    from image_retrieval_tpu_torch.index.plan import plan_index

    plan = plan_index(
        n_rows=args.rows, dim=args.dim, n_devices=args.devices,
        recall_floor=args.recall_floor, clustered=args.clustered,
        exact_scores=args.exact_scores, host_to_device_gbps=args.link_gbps)
    print(plan.describe())
    return 0


def cmd_analyze(args) -> int:
    """The full offline color-analysis workflow (app/workflow.py)."""
    from image_retrieval_tpu_torch.app.workflow import run_workflow

    results = run_workflow(
        coco_dir=args.coco_dir,
        annotation_file=args.annotation_file,
        output_dir=args.output_dir,
        skip_dataset=args.skip_dataset,
        skip_embeddings=args.skip_embeddings,
        synthetic=args.synthetic,
        fake_encoder=args.fake_encoder,
        num_examples=args.num_examples,
    )
    if results:
        print(json.dumps(results, indent=2))
    return 0 if results else 1


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="image-retrieval-torch",
        description="Text-to-image retrieval on an NVIDIA GPU (the PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def flag(sp, name, **kw):
        """--a-b, also spelled --a_b."""
        spellings = dict.fromkeys((f"--{name}", f"--{name.replace('-', '_')}"))
        sp.add_argument(*spellings, dest=name.replace("-", "_"), **kw)

    def common(sp):
        flag(sp, "folder", required=True, help="Image folder (searched recursively)")
        flag(sp, "journal-dir", default=None,
             help="Durable index directory: rows are recovered from it on start "
                  "and every mutation is write-ahead logged")
        flag(sp, "fake-encoder", action="store_true",
             help="Deterministic projection encoder (no CLIP weights needed)")
        flag(sp, "fast-encoder", action="store_true",
             help="vit_b32_serving(): every layer one int8 whole-layer kernel")
        flag(sp, "device", default="cuda",
             help="Device of the index and the encoder: cuda (default) or cpu")
        flag(sp, "approx-select", action="store_true",
             help="IndexConfig.approx_select: accepted, the answers are exact "
                  "(the JAX package's approximate selector is exact off a TPU)")
        flag(sp, "ann", choices=("exact", "ivf", "screen"), default="exact",
             help="Candidate generation: the exact index, an IVF over it (the "
                  "reference's Milvus IVF_FLAT), or a projection screen (int8 "
                  "sketch sweep -> exact rerank)")
        flag(sp, "nlist", type=int, default=1024,
             help="--ann ivf: clusters (reference ImageEmbeddingSystem.py:56-61); "
                  "0 = recommended_ivf's operating point for the gallery (exact "
                  "below its crossover)")
        flag(sp, "nprobe", type=int, default=10,
             help="--ann ivf: clusters probed per query (reference "
                  "image_search.py:88); 0 = auto")
        flag(sp, "screen-dims", type=int, default=128,
             help="--ann screen: the sketch's width")
        flag(sp, "screen-candidates", type=int, default=128,
             help="--ann screen: candidates per query reranked exactly")

    sp = sub.add_parser("search", help="Text or image search over an image folder")
    common(sp)
    sp.add_argument("query", nargs="?", default=None,
                    help="text query (omit when using --image)")
    flag(sp, "image", default=None,
         help="image-query search: rank the gallery by similarity to this image")
    flag(sp, "top-k", type=int, default=10)
    flag(sp, "optimized", action="store_true",
         help="Rank with the weighted optimized similarity")
    flag(sp, "filter", default=None,
         help="Boolean attribute expression, e.g. \"dir == 'red'\" (dir = the "
              "parent directory's name)")
    flag(sp, "save-grid", help="Write a thumbnail contact sheet PNG")
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("mi", help="Standard MI analysis")
    common(sp)
    flag(sp, "num-pairs", type=int, default=1000)
    flag(sp, "num-bins", type=int, default=20)
    sp.set_defaults(fn=cmd_mi)

    sp = sub.add_parser("geometric", help="Geometric (multi-metric) MI analysis")
    common(sp)
    flag(sp, "num-pairs", type=int, default=1000)
    flag(sp, "num-bins", type=int, default=20)
    flag(sp, "optimize", action="store_true", help="Run the weight grid search")
    flag(sp, "grid-size", type=int, default=3)
    flag(sp, "apply", action="store_true", help="Apply optimal weights to the searcher")
    flag(sp, "plot", help="Write an MI bar chart PNG here")
    flag(sp, "ci", action="store_true",
         help="Add bootstrap confidence intervals to the chart")
    sp.set_defaults(fn=cmd_geometric)

    sp = sub.add_parser("compare", help="Multi-metric search comparison")
    common(sp)
    sp.add_argument("query")
    flag(sp, "top-k", type=int, default=5)
    sp.set_defaults(fn=cmd_compare)

    sp = sub.add_parser("serve", help="Interactive micro-batched search server")
    common(sp)
    flag(sp, "top-k", type=int, default=10)
    flag(sp, "max-batch", type=int, default=64)
    sp.set_defaults(fn=cmd_serve)

    from image_retrieval_tpu_torch.index.plan import PCIE_GBPS

    sp = sub.add_parser(
        "plan", help="Pick the index tier for a corpus size (resident "
                     "f32/bf16/int8/int4, streamed, offloaded IVF)")
    flag(sp, "rows", type=int, required=True, help="corpus size in vectors")
    flag(sp, "dim", type=int, default=512)
    flag(sp, "devices", type=int, default=1, help="devices the rows shard over")
    flag(sp, "recall-floor", type=float, default=0.98,
         help="min recall@10 vs the f32 oracle; 1.0 forces exact tiers, 0.98 "
              "admits int8/int4")
    flag(sp, "clustered", action="store_true",
         help="corpus has cluster structure (gates IVF tiers; IVF recall "
              "collapses on i.i.d. data)")
    flag(sp, "exact-scores", action="store_true",
         help="require bit-faithful f32 similarity values (e.g. MI analysis)")
    flag(sp, "link-gbps", type=float, default=PCIE_GBPS,
         help="host->device GB/s for beyond-device-memory estimates (default: "
              "this card's pinned upload rate)")
    sp.set_defaults(fn=cmd_plan)

    sp = sub.add_parser("analyze", help="Full color-analysis workflow")
    flag(sp, "coco-dir")
    flag(sp, "annotation-file")
    flag(sp, "output-dir", default="color_analysis")
    flag(sp, "skip-dataset", action="store_true")
    flag(sp, "skip-embeddings", action="store_true")
    flag(sp, "synthetic", action="store_true")
    flag(sp, "fake-encoder", action="store_true")
    flag(sp, "num-examples", type=int, default=5)
    sp.set_defaults(fn=cmd_analyze)
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
