"""The port's data/{color,synthetic,dataset}.py against the JAX package's:
dominant colors on the CPU (names equal, centres within 1e-4; an unstable
luminance sort would pick other initial centres and fail), synthetic JPEGs
byte-identical, metadata.csv and pairs.json byte-identical for the synthetic
and a COCO-format tree, each package reading the other's files."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from image_retrieval_tpu.data import color as jc
from image_retrieval_tpu.data import dataset as jd
from image_retrieval_tpu.data import synthetic as js
from image_retrieval_tpu_torch.data import color as tc
from image_retrieval_tpu_torch.data import dataset as td
from image_retrieval_tpu_torch.data import synthetic as ts
from tests.test_dataset import make_mini_coco
from tests.test_reference_parity import _make_coco_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTRE_ATOL = 1e-4


def _images():
    """Synthetic silhouettes, solid colours, a 3/4-brown image, tricolour
    blocks and seeded noise: the shapes the COCO filter and tests feed."""
    rng = np.random.default_rng(0)
    imgs = [np.asarray(ts.synth_image(ci, c, v)) for ci in range(10)
            for c in ("brown", "white", "black") for v in range(2)]
    imgs += [np.full((64, 64, 3), c, np.uint8)
             for c in [(235, 235, 235), (20, 20, 20), (139, 69, 19), (90, 140, 220)]]
    maj = np.full((64, 64, 3), (139, 69, 19), np.uint8)
    maj[:16] = (250, 250, 250)
    imgs.append(maj)
    for dominant in ((250, 250, 250), (15, 15, 15), (160, 60, 30)):
        arr = np.zeros((32, 32, 3), np.uint8)
        arr[:22], arr[22:27], arr[27:] = dominant, (40, 160, 220), (120, 80, 10)
        imgs.append(arr)
    imgs += [rng.integers(0, 256, (48, 80, 3), dtype=np.uint8) for _ in range(4)]
    return imgs


def _reversed_ties_argsort(x, dim=-1, stable=False, **kw):
    """A valid unstable sort: among equal keys, the later index first."""
    n = x.shape[dim]
    return n - 1 - torch.sort(torch.flip(x, [dim]), dim=dim, stable=True).indices


def _tie_image():
    """Half brown, half blue at one luminance (227), a dark and a bright
    band: the median pixel of the luminance sort decides which half the
    middle centre starts in, and with it the dominant cluster."""
    img = np.zeros((64, 64, 3), np.uint8)
    img[2:32] = (200, 20, 7)
    img[32:62] = (7, 20, 200)
    img[62:] = 255
    return img


def test_classify_rgb_and_mean_method_equal_jax():
    rng = np.random.default_rng(1)
    for r, g, b in rng.integers(0, 256, (500, 3)):
        assert tc.classify_rgb(r, g, b) == jc.classify_rgb(r, g, b)
    for edge in [(200, 200, 200), (201, 201, 201), (60, 60, 60), (59, 59, 59),
                 (101, 99, 79), (100, 99, 79)]:
        assert tc.classify_rgb(*edge) == jc.classify_rgb(*edge)
    imgs = _images()
    assert (tc.dominant_colors_batch(imgs, method="mean", device="cpu")
            == jc.dominant_colors_batch(imgs, method="mean"))


def test_dominant_colors_cpu_equal_jax():
    imgs = _images()
    batch = np.stack([tc._sample_pixels(im) for im in imgs])
    np.testing.assert_array_equal(batch, np.stack([jc._sample_pixels(im) for im in imgs]))
    want = np.asarray(jc._dominant_batch_jit(batch))
    got = tc._kmeans_batch(torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CENTRE_ATOL)
    names = tc.dominant_colors_batch(imgs, device="cpu")
    assert names == jc.dominant_colors_batch(imgs)
    assert {"white", "black", "brown", "other"} <= set(names)
    assert tc.extract_dominant_color(imgs[-8], device="cpu") == "brown"  # 3/4 brown
    assert tc.dominant_colors_batch([], device="cpu") == []


def test_an_unstable_luminance_sort_would_fail(monkeypatch):
    img = _tie_image()
    want = np.asarray(jc._dominant_batch_jit(tc._sample_pixels(img)[None]))
    assert jc.dominant_colors_batch([img]) == ["brown"]
    got = tc._kmeans_batch(torch.from_numpy(tc._sample_pixels(img)[None])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CENTRE_ATOL)
    assert tc.dominant_colors_batch([img], device="cpu") == ["brown"]
    monkeypatch.setattr(torch, "argsort", _reversed_ties_argsort)
    bad = tc._kmeans_batch(torch.from_numpy(tc._sample_pixels(img)[None])).numpy()
    assert np.abs(bad - want).max() > 100  # the other half won
    assert tc.dominant_colors_batch([img], device="cpu") == ["other"]


def test_dominant_colors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.dominant_colors_batch([np.zeros((8, 8, 3), np.uint8)])


def test_synthetic_images_and_jpegs_byte_identical(tmp_path):
    for ci, color, v in [(0, "brown", 0), (3, "white", 2), (9, "black", 1), (13, "brown", 4)]:
        assert ts.synth_image(ci, color, v).tobytes() == js.synth_image(ci, color, v).tobytes()
    cats, colors = ["dog", "bird", "bicycle"], ["brown", "white", "black"]
    meta_t = ts.create_synthetic_dataset(str(tmp_path / "t"), cats, colors, 2)
    meta_j = js.create_synthetic_dataset(str(tmp_path / "j"), cats, colors, 2)
    assert len(meta_t) == len(meta_j) == 18
    for rt, rj in zip(meta_t, meta_j):
        assert os.path.relpath(rt["path"], tmp_path / "t") == os.path.relpath(rj["path"],
                                                                              tmp_path / "j")
        with open(rt["path"], "rb") as ft, open(rj["path"], "rb") as fj:
            assert ft.read() == fj.read()


def _build_both(base, build_jax, build_port):
    """Run the JAX build at `base`, keep its two files' bytes, clear, run the
    port's build at the same path: the bytes of both and their returns."""
    want = build_jax(base)
    files = {n: open(os.path.join(base, n), "rb").read() for n in ("metadata.csv", "pairs.json")}
    shutil.rmtree(base)
    got = build_port(base)
    return want, files, got


def test_prepare_color_dataset_files_byte_identical(tmp_path):
    base = str(tmp_path / "color_dataset")
    (pairs_j, meta_j), files, (pairs_t, meta_t) = _build_both(
        base, lambda b: jd.prepare_color_dataset(base_dir=b, num_examples=2),
        lambda b: td.prepare_color_dataset(base_dir=b, num_examples=2, device="cpu"))
    assert meta_t == meta_j and len(meta_t) == 60
    assert pairs_t == pairs_j
    assert [len(pairs_t[k]) for k in pairs_t] == [30, 120, 540, 1080]
    for name, want in files.items():
        with open(os.path.join(base, name), "rb") as f:
            assert f.read() == want, name
    assert os.path.exists(os.path.join(base, "dataset_examples.png"))
    # each package reads the other's metadata.csv (identical bytes: the
    # port's file is the JAX package's)
    rows = td.read_metadata(os.path.join(base, "metadata.csv"))
    assert rows == [{k: str(v) for k, v in m.items()} for m in meta_j]
    df = pd.read_csv(os.path.join(base, "metadata.csv"))
    assert list(df.columns) == ["path", "category", "color", "original_id", "original_path"]
    assert df["path"].tolist() == [m["path"] for m in meta_t]


def test_coco_tree_files_byte_identical(tmp_path):
    coco_dir, ann_file = _make_coco_tree(tmp_path)
    base = str(tmp_path / "out")
    (pairs_j, meta_j), files, (pairs_t, meta_t) = _build_both(
        base, lambda b: jd.prepare_color_dataset(coco_dir, ann_file, b, num_examples=2),
        lambda b: td.prepare_color_dataset(coco_dir, ann_file, b, num_examples=2,
                                           device="cpu"))
    assert meta_t == meta_j and pairs_t == pairs_j
    assert {(m["category"], m["color"]) for m in meta_t} == {
        (c, col) for c in ("dog", "car", "chair") for col in ("white", "black", "brown")}
    assert all(isinstance(m["original_id"], int) for m in meta_t)
    for name, want in files.items():
        with open(os.path.join(base, name), "rb") as f:
            assert f.read() == want, name
    rows = td.read_metadata(os.path.join(base, "metadata.csv"))
    assert [r["original_id"] for r in rows] == [str(m["original_id"]) for m in meta_j]
    # the JAX analyzer loads the port's dataset, the port's the JAX one's
    from image_retrieval_tpu.analysis.color_mi import ColorMIAnalyzer as JaxAnalyzer
    from image_retrieval_tpu_torch.analysis.color_mi import ColorMIAnalyzer

    emb = tmp_path / "e.npz"
    np.savez(emb, embeddings=np.array({m["path"]: np.ones(4, np.float32) for m in meta_t},
                                      dtype=object))
    for cls in (JaxAnalyzer, ColorMIAnalyzer):
        an = cls(base_dir=base)
        assert an.load_dataset(str(emb)) == (True, "Dataset loaded successfully")
        assert len(an.metadata) == len(meta_t)
        assert {k: len(v) for k, v in an.pairs.items()} == {k: len(v) for k, v in
                                                             pairs_t.items()}


def test_filter_coco_images_quota_equals_jax(tmp_path, rng):
    img_dir, ann_file, _ = make_mini_coco(tmp_path, rng)
    mj = jd.ColorDatasetManager(str(tmp_path / "j"), num_examples=1, color_batch=2)
    mj.filter_coco_images(img_dir, ann_file)
    mt = td.ColorDatasetManager(str(tmp_path / "t"), num_examples=1, color_batch=2,
                                device="cpu")
    mt.filter_coco_images(img_dir, ann_file)
    strip = lambda rows, b: [dict(r, path=os.path.relpath(r["path"], b)) for r in rows]
    assert strip(mt.metadata, tmp_path / "t") == strip(mj.metadata, tmp_path / "j")
    assert len(mt.metadata) == 3  # dog brown (quota 1), dog white, cat black
    # a missing annotation file logs and selects nothing, as in JAX
    mt2 = td.ColorDatasetManager(str(tmp_path / "t2"), device="cpu")
    mt2.filter_coco_images(img_dir, str(tmp_path / "missing.json"))
    assert mt2.metadata == []


def test_pair_enumeration_equals_jax(tmp_path):
    def manager(mod, sub, **kw):
        m = mod.ColorDatasetManager(str(tmp_path / sub), num_examples=2, **kw)
        m.categories, m.colors = ["dog", "cat", "car"], ["brown", "white", "black"]
        m.create_synthetic()
        # drop one bucket: the enumeration skips empty (category, colour) cells
        m.metadata = [r for r in m.metadata if (r["category"], r["color"]) != ("cat", "white")]
        return m

    mt, mj = manager(td, "t", device="cpu"), manager(jd, "j")
    rel = lambda pairs, b: {k: [(os.path.relpath(p, b), os.path.relpath(q, b)) for p, q in v]
                            for k, v in pairs.items()}
    assert (rel(mt.generate_relationship_pairs(), tmp_path / "t")
            == rel(mj.generate_relationship_pairs(), tmp_path / "j"))
    mt.save_metadata()
    mj.save_metadata()
    with open(tmp_path / "t" / "metadata.csv") as f:
        port = f.read()
    with open(tmp_path / "j" / "metadata.csv") as f:
        assert port == f.read().replace(str(tmp_path / "j"), str(tmp_path / "t"))
    empty = td.ColorDatasetManager(str(tmp_path / "e"), device="cpu")
    assert all(v == [] for v in empty.generate_relationship_pairs().values())
    empty.save_metadata()  # pandas writes a bare line for no rows
    with open(tmp_path / "e" / "metadata.csv", "rb") as f:
        assert f.read() == pd.DataFrame([]).to_csv(index=False).encode()


def test_metadata_csv_quoting_matches_pandas(tmp_path):
    m = td.ColorDatasetManager(str(tmp_path / "q"), device="cpu")
    m.metadata = [{"path": "a,b/1.jpg", "category": 'say "hi"', "color": "brown",
                   "original_id": 7, "original_path": None}]
    m.save_metadata()
    with open(tmp_path / "q" / "metadata.csv", "rb") as f:
        assert f.read() == pd.DataFrame(m.metadata).to_csv(index=False).encode()


def test_data_exports_resolve_lazily():
    import image_retrieval_tpu_torch.data as data

    assert data.prepare_color_dataset is td.prepare_color_dataset
    assert data.dominant_colors_batch is tc.dominant_colors_batch
    assert data.CATEGORIES == jd.CATEGORIES and data.COLORS == jd.COLORS
    with pytest.raises(AttributeError):
        data.no_such_name
    # the decode loader (imported by its spawned workers) imports no torch
    out = subprocess.run(
        [sys.executable, "-c", "import sys, image_retrieval_tpu_torch.data.loader; "
         "print('torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
