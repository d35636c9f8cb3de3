"""Data: the host decode loader (framework-free), dominant colors, the
synthetic generator and the color dataset builder.

The JAX package's exports, resolved on first use: the loader's spawned
decode workers import this package and must not import torch."""

_EXPORTS = {
    "classify_rgb": "image_retrieval_tpu_torch.data.color",
    "extract_dominant_color": "image_retrieval_tpu_torch.data.color",
    "dominant_colors_batch": "image_retrieval_tpu_torch.data.color",
    "ColorDatasetManager": "image_retrieval_tpu_torch.data.dataset",
    "prepare_color_dataset": "image_retrieval_tpu_torch.data.dataset",
    "CATEGORIES": "image_retrieval_tpu_torch.data.dataset",
    "COLORS": "image_retrieval_tpu_torch.data.dataset",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
