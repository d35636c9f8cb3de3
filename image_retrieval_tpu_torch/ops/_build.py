"""Build and bind the port's CUDA kernels (nvcc + ctypes, no PyTorch headers).

The sources under ``csrc/`` are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``_build/<hash of sources and flags>/`` inside the package (listed in
.gitignore), and loaded with ctypes. The library has a plain C interface, so
a build takes seconds instead of the minutes a PyTorch-header extension
costs. No ``--use_fast_math``: the kernels rely on IEEE division, square
root and exp. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("layer_block_int8.cu",)
HEADERS = ("layer_block_int8.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libirt_kernels.so"

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's kernels "
                       "are built from csrc/ at first use on a CUDA machine")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/ into the hashed build directory (if not there yet) and
    return the library path; nvcc's output (ptxas registers and spills) is
    kept beside it in build.log. Concurrent builds race benignly: each
    writes its own temporary file and renames it into place."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels; argtypes declared
    so every pointer and the stream pass as 64-bit values."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.irt_layer_block_int8_workspace_bytes.argtypes = [i, i, i, i]
            lib.irt_layer_block_int8_workspace_bytes.restype = ctypes.c_size_t
            lib.irt_attention_smem_bytes.argtypes = [i, i]
            lib.irt_attention_smem_bytes.restype = ctypes.c_size_t
            lib.irt_layer_block_int8.argtypes = (
                [p] * 2 + [p] * 16 + [p] + [i] * 7 + [ctypes.c_float, p])
            lib.irt_layer_block_int8.restype = i
            lib.irt_error_string.argtypes = [i]
            lib.irt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
