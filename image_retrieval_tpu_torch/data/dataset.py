"""Color-controlled dataset builder (COCO filtering + relationship pairs) —
port of ``image_retrieval_tpu/data/dataset.py``.

The reference's ColorDatasetManager (reference imageProcessing.py:40-571):
COCO annotation parsing and file copying stay host-side, dominant-color
extraction runs batched on `device` (data/color.py) instead of one sklearn
KMeans per image. Output contracts are identical, and metadata.csv and
pairs.json are byte-identical to the JAX package's (metadata.csv is written
with the csv module as pandas' to_csv(index=False) writes it):

  metadata.csv columns path,category,color,original_id,original_path
                                   (reference imageProcessing.py:389-394)
  pairs.json: 4 relationship types -> [[p1, p2], ...] with base-dir-relative
              paths            (reference imageProcessing.py:549-561)

Deliberate divergences from reference bugs (SURVEY §7 "hard parts"):
  * create_dataset() without COCO uses a real synthetic generator
    (data/synthetic.py) instead of calling undefined methods
    (imageProcessing.py:414,417).
  * diff_object_diff_color pair enumeration iterates categories in
    insertion order instead of Python set order (imageProcessing.py:354-357,
    whose ordering is hash-randomized across runs).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import shutil
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from image_retrieval_tpu_torch.data.color import dominant_colors_batch
from image_retrieval_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)

CATEGORIES = [
    "dog", "cat", "horse", "bird", "car",
    "bottle", "chair", "person", "boat", "bicycle",
]
COLORS = ["brown", "white", "black"]

PairDict = Dict[str, List[Tuple[str, str]]]


class ColorDatasetManager:
    """Builds the 10 categories x 3 colors x N examples benchmark dataset."""

    def __init__(self, base_dir: str = "color_dataset", num_examples: int = 5,
                 color_batch: int = 64, *, device: DeviceLike = "cuda"):
        """`device` runs the dominant-color k-means of filter_coco_images
        (the synthetic path touches no device)."""
        self.base_dir = Path(base_dir)
        self.categories = list(CATEGORIES)
        self.colors = list(COLORS)
        self.num_examples = num_examples
        self.color_batch = color_batch  # device batch for dominant-color
        self.device = device
        self.metadata: List[Dict[str, Any]] = []
        os.makedirs(self.base_dir, exist_ok=True)
        for category in self.categories:
            for color in self.colors:
                os.makedirs(self.base_dir / category / color, exist_ok=True)

    # -- COCO filtering ------------------------------------------------------

    def filter_coco_images(self, coco_dir: str, annotation_file: str) -> None:
        """Select per-(category, color) examples from COCO
        (reference imageProcessing.py:122-216), with color extraction
        batched on device."""
        try:
            with open(annotation_file) as f:
                annotations = json.load(f)
        except Exception as e:
            logger.error(f"Error loading annotation file: {e}")
            return

        id_to_file = {img["id"]: img["file_name"] for img in annotations.get("images", [])}
        if not id_to_file:
            logger.error("No image data found in annotations file")
            return
        categories_dict = {c["id"]: c["name"] for c in annotations.get("categories", [])}
        id_to_categories: Dict[Any, List[str]] = defaultdict(list)
        for ann in annotations.get("annotations", []):
            name = categories_dict.get(ann.get("category_id"))
            if name in self.categories:
                id_to_categories[ann["image_id"]].append(name)

        # Candidate list in annotation order (reference iteration order).
        candidates = [
            (image_id, cats[0])
            for image_id, cats in id_to_categories.items()
            if cats
        ]
        selected: Dict[str, Dict[str, List[Tuple[Any, str]]]] = defaultdict(
            lambda: defaultdict(list)
        )
        processed = found = 0
        batch_imgs: List[np.ndarray] = []
        batch_meta: List[Tuple[Any, str, str]] = []

        def flush():
            nonlocal found
            if not batch_imgs:
                return
            colors = dominant_colors_batch(batch_imgs, device=self.device)
            for (image_id, category, img_path), color in zip(batch_meta, colors):
                if color in self.colors:
                    found += 1
                    bucket = selected[category][color]
                    if len(bucket) < self.num_examples:
                        bucket.append((image_id, img_path))
            batch_imgs.clear()
            batch_meta.clear()

        for image_id, category in candidates:
            # Skip decode when the (category, every color) quota is full.
            # (.get, not [], so probing never inserts defaultdict entries —
            # the copy loop below iterates in first-SELECTION order, matching
            # the reference's imageProcessing.py:193-198.)
            cat_sel = selected.get(category, {})
            if all(
                len(cat_sel.get(c, ())) >= self.num_examples for c in self.colors
            ):
                continue
            img_path = os.path.join(coco_dir, id_to_file[image_id])
            if not os.path.exists(img_path):
                logger.warning(f"Image file not found: {img_path}")
                continue
            try:
                with Image.open(img_path) as im:
                    arr = np.asarray(im.convert("RGB"))
            except Exception as e:
                logger.error(f"Error processing image {image_id}: {e}")
                continue
            processed += 1
            batch_imgs.append(arr)
            batch_meta.append((image_id, category, img_path))
            if len(batch_imgs) >= self.color_batch:
                flush()
        flush()

        logger.info(f"Processed {processed} images, found {found} matching criteria")

        for category in selected:
            for color in selected[category]:
                dest_dir = self.base_dir / category / color
                os.makedirs(dest_dir, exist_ok=True)
                for i, (image_id, img_path) in enumerate(selected[category][color]):
                    dest_path = dest_dir / f"{i + 1}.jpg"
                    try:
                        shutil.copy(img_path, dest_path)
                        self.metadata.append(
                            {
                                "path": str(dest_path),
                                "category": category,
                                "color": color,
                                "original_id": image_id,
                                "original_path": img_path,
                            }
                        )
                    except Exception as e:
                        logger.error(f"Error copying {img_path}: {e}")
        logger.info(f"Selected {len(self.metadata)} images for the dataset")

    # -- synthetic path ------------------------------------------------------

    def create_synthetic(self) -> None:
        """Generate the full tree synthetically (the reference's intended but
        unimplemented from-scratch mode, imageProcessing.py:408-417)."""
        from image_retrieval_tpu_torch.data.synthetic import create_synthetic_dataset

        self.metadata = create_synthetic_dataset(
            str(self.base_dir), self.categories, self.colors, self.num_examples
        )

    # -- pairs ---------------------------------------------------------------

    def generate_relationship_pairs(self) -> PairDict:
        """Four relationship types, identical enumeration semantics to
        reference imageProcessing.py:286-387."""
        pairs: PairDict = {
            "same_object_same_color": [],
            "same_object_diff_color": [],
            "diff_object_same_color": [],
            "diff_object_diff_color": [],
        }
        if len(self.metadata) < 2:
            logger.warning("Not enough images to generate pairs")
            return pairs

        by_cat_color: Dict[Tuple[str, str], List[str]] = defaultdict(list)
        for meta in self.metadata:
            by_cat_color[(meta["category"], meta["color"])].append(meta["path"])

        # same object, same color: all pairs within a bucket
        for (category, color), paths in by_cat_color.items():
            for i in range(len(paths)):
                for j in range(i + 1, len(paths)):
                    pairs["same_object_same_color"].append((paths[i], paths[j]))

        # same object, different color
        for category in self.categories:
            cat_colors = [c for (cat, c), p in by_cat_color.items() if cat == category and p]
            for i1, c1 in enumerate(cat_colors):
                for c2 in cat_colors[i1 + 1 :]:
                    for p1 in by_cat_color[(category, c1)]:
                        for p2 in by_cat_color[(category, c2)]:
                            pairs["same_object_diff_color"].append((p1, p2))

        # different object, same color
        for color in self.colors:
            col_cats = [cat for (cat, c), p in by_cat_color.items() if c == color and p]
            for i1, cat1 in enumerate(col_cats):
                for cat2 in col_cats[i1 + 1 :]:
                    for p1 in by_cat_color[(cat1, color)]:
                        for p2 in by_cat_color[(cat2, color)]:
                            pairs["diff_object_same_color"].append((p1, p2))

        # different object, different color — insertion-ordered categories
        cats_with_images = list(
            dict.fromkeys(cat for (cat, _), p in by_cat_color.items() if p)
        )
        for i1, cat1 in enumerate(cats_with_images):
            for cat2 in cats_with_images[i1 + 1 :]:
                colors1 = [c for (cat, c), p in by_cat_color.items() if cat == cat1 and p]
                colors2 = [c for (cat, c), p in by_cat_color.items() if cat == cat2 and p]
                for c1 in colors1:
                    for c2 in colors2:
                        if c1 != c2:
                            for p1 in by_cat_color[(cat1, c1)]:
                                for p2 in by_cat_color[(cat2, c2)]:
                                    pairs["diff_object_diff_color"].append((p1, p2))

        for rel_type, rel_pairs in pairs.items():
            if not rel_pairs:
                logger.warning(f"No pairs found for relationship type: {rel_type}")
            logger.info(f"Generated {len(rel_pairs)} {rel_type} pairs")
        return pairs

    # -- persistence ---------------------------------------------------------

    def save_metadata(self) -> None:
        """metadata.csv as pandas' DataFrame(rows).to_csv(index=False)
        writes it: the columns in order of first appearance, minimal
        quoting, "\n" line ends, None as an empty field."""
        columns = list(dict.fromkeys(k for row in self.metadata for k in row))
        with open(self.base_dir / "metadata.csv", "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(columns)
            for row in self.metadata:
                writer.writerow([row.get(c) for c in columns])

    def save_pairs(self, pairs: PairDict) -> None:
        """pairs.json with base-dir-relative paths
        (reference imageProcessing.py:549-561)."""
        base_str = str(self.base_dir) + os.sep
        serializable = {
            rel: [
                (
                    p1[len(base_str):] if p1.startswith(base_str) else p1,
                    p2[len(base_str):] if p2.startswith(base_str) else p2,
                )
                for p1, p2 in rel_pairs
            ]
            for rel, rel_pairs in pairs.items()
        }
        with open(self.base_dir / "pairs.json", "w") as f:
            json.dump(serializable, f)

    def create_dataset(
        self,
        coco_dir: Optional[str] = None,
        annotation_file: Optional[str] = None,
    ) -> PairDict:
        if coco_dir and annotation_file:
            self.filter_coco_images(coco_dir, annotation_file)
        else:
            logger.info("COCO dataset not provided. Using synthetic dataset.")
            self.create_synthetic()
        self.save_metadata()
        pairs = self.generate_relationship_pairs()
        self.save_pairs(pairs)
        return pairs


def visualize_dataset_examples(base_dir: str, output_path: Optional[str] = None):
    """4x4 grid of example pairs per relationship type
    (reference imageProcessing.py:442-505)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pairs_path = Path(base_dir) / "pairs.json"
    if not pairs_path.exists():
        logger.error("Pairs file not found. Run create_dataset first.")
        return None
    with open(pairs_path) as f:
        pairs = json.load(f)
    fig, axes = plt.subplots(4, 4, figsize=(12, 12))
    row_titles = [
        "Same Object, Same Color",
        "Same Object, Different Color",
        "Different Object, Same Color",
        "Different Object, Different Color",
    ]
    for i, rel_type in enumerate(list(pairs.keys())[:4]):
        for j, (rel1, rel2) in enumerate(pairs[rel_type][:2]):
            p1 = os.path.join(base_dir, rel1)
            p2 = os.path.join(base_dir, rel2)
            try:
                img1 = Image.open(p1).convert("RGB")
                img2 = Image.open(p2).convert("RGB")
                axes[i, j * 2].imshow(img1)
                axes[i, j * 2 + 1].imshow(img2)
            except Exception as e:
                logger.warning(f"could not load pair images: {e}")
        for ax in axes[i]:
            ax.axis("off")
        axes[i, 0].set_title(row_titles[i], fontsize=10, loc="left")
    plt.tight_layout()
    if output_path:
        plt.savefig(output_path, dpi=120)
        logger.info(f"Dataset visualization saved to {output_path}")
    plt.close(fig)
    return fig


def prepare_color_dataset(
    coco_dir: Optional[str] = None,
    annotation_file: Optional[str] = None,
    base_dir: str = "color_dataset",
    num_examples: int = 5,
    *,
    device: DeviceLike = "cuda",
) -> Tuple[PairDict, List[Dict[str, Any]]]:
    """End-to-end dataset build (reference imageProcessing.py:508-571).

    Unlike the reference, a missing COCO dir falls back to the synthetic
    generator instead of erroring out. `device` runs the COCO filter's
    dominant colors."""
    manager = ColorDatasetManager(base_dir, num_examples=num_examples, device=device)
    if coco_dir and annotation_file and os.path.isdir(coco_dir) and os.path.isfile(annotation_file):
        manager.filter_coco_images(coco_dir, annotation_file)
    else:
        if coco_dir or annotation_file:
            logger.warning("COCO inputs missing/invalid; using synthetic dataset")
        manager.create_synthetic()
    manager.save_metadata()
    pairs = manager.generate_relationship_pairs()
    if pairs:
        manager.save_pairs(pairs)
    if manager.metadata:
        try:
            visualize_dataset_examples(
                base_dir, os.path.join(base_dir, "dataset_examples.png")
            )
        except Exception as e:
            logger.warning(f"dataset visualization failed: {e}")
    logger.info(f"Dataset creation complete. Found {len(manager.metadata)} images.")
    return pairs, manager.metadata


def read_metadata(path) -> List[Dict[str, str]]:
    """The rows of a metadata.csv as dicts of strings (the port's reader in
    place of pandas' read_csv; callers use the rows' fields)."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))
