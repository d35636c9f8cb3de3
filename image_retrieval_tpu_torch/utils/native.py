"""ctypes bindings for the native host runtime (native/ir_native.cpp).

The port's own copy of the JAX package's ``utils/native.py``. It builds and
loads ``native/libirnative.so`` from the repository's ``native/`` directory
(g++; Makefile there), which belongs to neither package, on first use, and
reports unavailability so callers take the pure-Python paths. The ABI is
plain C + ctypes.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libirnative.so")
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "libirnative.so"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception as e:
        logger.warning(f"native build failed: {e}")
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.path.exists(os.path.join(_NATIVE_DIR, "ir_native.cpp")):
        # always invoke make: it is an mtime no-op when the .so is fresh,
        # and rebuilds when ir_native.cpp changed (a stale committed binary
        # would otherwise silently shadow source edits)
        if not _build() and not os.path.exists(_LIB_PATH):
            return None
    elif not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ir_decode_preprocess_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.ir_decode_preprocess_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.ir_decode_thumbnail_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.ir_cosine_topk.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        _lib = lib
    except OSError as e:
        logger.warning(f"native lib load failed: {e}")
    return _lib


def available() -> bool:
    return get_lib() is not None


def _paths_array(paths: Sequence[str]):
    enc = [p.encode() for p in paths]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    return arr, enc  # keep enc alive


def decode_preprocess_batch(
    paths: Sequence[str], size: int = 224, threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Native decode -> resize -> crop -> CLIP-normalize.

    Returns (batch (N,size,size,3) f32, ok (N,) bool)."""
    lib = get_lib()
    assert lib is not None, "native library not available"
    n = len(paths)
    threads = threads or (os.cpu_count() or 1)
    out = np.empty((n, size, size, 3), np.float32)
    status = np.empty((n,), np.int32)
    arr, _keep = _paths_array(paths)
    lib.ir_decode_preprocess_batch(
        arr, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    return out, status.astype(bool)


def decode_preprocess_batch_u8(
    paths: Sequence[str], size: int = 224, threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Native decode -> resize -> crop, emitting RAW uint8 RGB.

    The high-throughput ingest form: /255 + CLIP mean/std run on device
    (models/preprocess.py normalize_u8_device), so the host->device
    transfer ships 1/4 the bytes of the f32 form and the host skips the
    normalize pass. Returns (batch (N,size,size,3) u8, ok (N,) bool)."""
    lib = get_lib()
    assert lib is not None, "native library not available"
    n = len(paths)
    threads = threads or (os.cpu_count() or 1)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.empty((n,), np.int32)
    arr, _keep = _paths_array(paths)
    lib.ir_decode_preprocess_batch_u8(
        arr, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    return out, status.astype(bool)


def decode_thumbnail_batch(
    paths: Sequence[str], size: int = 64, threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Native decode to fixed-size uint8 thumbnails (dominant-color stage)."""
    lib = get_lib()
    assert lib is not None, "native library not available"
    n = len(paths)
    threads = threads or (os.cpu_count() or 1)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.empty((n,), np.int32)
    arr, _keep = _paths_array(paths)
    lib.ir_decode_thumbnail_batch(
        arr, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    return out, status.astype(bool)


def cosine_topk(
    query: np.ndarray, gallery: np.ndarray, k: int, threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Native exact cosine top-k (host oracle for the device index)."""
    lib = get_lib()
    assert lib is not None, "native library not available"
    q = np.ascontiguousarray(query, np.float32)
    g = np.ascontiguousarray(gallery, np.float32)
    n, d = g.shape
    kk = min(k, n)
    scores = np.empty((kk,), np.float32)
    idx = np.empty((kk,), np.int32)
    threads = threads or (os.cpu_count() or 1)
    lib.ir_cosine_topk(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, d, kk,
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    return scores, idx
