"""Build and bind the port's CUDA kernels (nvcc + ctypes, no PyTorch headers).

Each source under ``csrc/`` is compiled at first use, all at once, one nvcc
process per source,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c <source>.cu

and the objects are linked into one shared library (``nvcc -shared``) in
``_build/<hash of sources and flags>/`` inside the package (listed in
.gitignore), loaded with ctypes. The library has a plain C interface, so a
build takes seconds instead of the minutes a PyTorch-header extension
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
SOURCES = ("layer_block_int8.cu", "attention_block_int8.cu", "mlp_block_int8.cu",
           "quant_dense.cu", "int4_screen.cu", "fused_metrics.cu", "layer_block.cu",
           "attention_block.cu", "mlp_block.cu", "multihead_attention.cu",
           "attention_block_train.cu", "gemm_sm90.cu")
HEADERS = ("block_common.cuh", "int8_common.cuh", "layer_block_int8.cuh",
           "attention_block_int8.cuh", "mlp_block_int8.cuh", "quant_dense.cuh",
           "int4_screen.cuh", "fused_metrics.cuh", "dense_common.cuh", "dense_blocks.cuh",
           "attention_mma.cuh", "attention_sm90.cuh", "gemm_sm90.cuh", "int8_sweep_sm90.cuh",
           "int4_screen_sm90.cuh", "f32_sweep_sm90.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    writes its own temporary files and renames the library into place."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc, tag = find_nvcc(), f"tmp{os.getpid()}"
    cmds, procs = [], []
    for src in SOURCES:
        obj = os.path.join(out_dir, f"{os.path.splitext(src)[0]}.{tag}.o")
        cmds.append([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj])
        procs.append(subprocess.Popen(cmds[-1], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [" ".join(cmd) + "\n" + p.communicate()[0] for cmd, p in zip(cmds, procs)]
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", f"{lib_path}.{tag}",
                *(cmd[-1] for cmd in cmds)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        failed = [proc.returncode] if proc.returncode != 0 else []
    log = "".join(logs)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    for cmd in cmds:
        if os.path.exists(cmd[-1]):
            os.remove(cmd[-1])
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
    os.replace(f"{lib_path}.{tag}", lib_path)
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
            lib.irt_attention_smem_bytes.argtypes = [i, i, i]
            lib.irt_attention_smem_bytes.restype = ctypes.c_size_t
            lib.irt_attention_tile_rows.argtypes = [i, i, i, i]
            lib.irt_attention_tile_rows.restype = i
            lib.irt_attention_route.argtypes = [i, i, i]
            lib.irt_attention_route.restype = i
            lib.irt_attention_division_check.argtypes = [p, ctypes.c_longlong, p]
            lib.irt_attention_division_check.restype = i
            lib.irt_attention_exp_check.argtypes = [p, ctypes.c_longlong, p]
            lib.irt_attention_exp_check.restype = i
            lib.irt_layer_block_int8.argtypes = (
                [p] * 2 + [p] * 16 + [p] + [i] * 7 + [ctypes.c_float, p])
            lib.irt_layer_block_int8.restype = i
            lib.irt_attention_block_int8_workspace_bytes.argtypes = [i, i, i]
            lib.irt_attention_block_int8_workspace_bytes.restype = ctypes.c_size_t
            lib.irt_attention_block_int8.argtypes = (
                [p] * 2 + [p] * 8 + [p] + [i] * 6 + [ctypes.c_float, p])
            lib.irt_attention_block_int8.restype = i
            lib.irt_attention.argtypes = [p, p] + [i] * 6 + [ctypes.c_float, p]
            lib.irt_attention.restype = i
            lib.irt_mlp_block_int8_workspace_bytes.argtypes = [i, i, i]
            lib.irt_mlp_block_int8_workspace_bytes.restype = ctypes.c_size_t
            lib.irt_mlp_block_int8.argtypes = [p] * 2 + [p] * 8 + [p] + [i] * 4 + [p]
            lib.irt_mlp_block_int8.restype = i
            lib.irt_quant_dense_workspace_bytes.argtypes = [i, i]
            lib.irt_quant_dense_workspace_bytes.restype = ctypes.c_size_t
            lib.irt_quant_dense.argtypes = [p] * 6 + [i] * 5 + [p]
            lib.irt_quant_dense.restype = i
            lib.irt_layer_block_workspace_bytes.argtypes = [i, i, i, i]
            lib.irt_layer_block_workspace_bytes.restype = ctypes.c_size_t
            lib.irt_layer_block.argtypes = (
                [p] * 2 + [p] * 12 + [p] + [i] * 7 + [ctypes.c_float, p])
            lib.irt_layer_block.restype = i
            lib.irt_attention_block_workspace_bytes.argtypes = [i, i, i]
            lib.irt_attention_block_workspace_bytes.restype = ctypes.c_size_t
            lib.irt_attention_block.argtypes = (
                [p] * 2 + [p] * 6 + [p] + [i] * 6 + [ctypes.c_float, p])
            lib.irt_attention_block.restype = i
            lib.irt_attention_block_train_workspace_bytes.argtypes = [i, i, i]
            lib.irt_attention_block_train_workspace_bytes.restype = ctypes.c_size_t
            lib.irt_attention_block_train.argtypes = (
                [p] * 5 + [p] * 6 + [p] + [i] * 6 + [ctypes.c_float, p])
            lib.irt_attention_block_train.restype = i
            lib.irt_mlp_block_workspace_bytes.argtypes = [i, i, i, i]
            lib.irt_mlp_block_workspace_bytes.restype = ctypes.c_size_t
            lib.irt_mlp_block.argtypes = [p] * 2 + [p] * 6 + [p] + [i] * 4 + [p]
            lib.irt_mlp_block.restype = i
            lib.irt_multihead_attention.argtypes = [p] * 4 + [i] * 5 + [ctypes.c_float, p]
            lib.irt_multihead_attention.restype = i
            lib.irt_attention_as_route.argtypes = (
                [p] * 3 + [ctypes.c_longlong, p] + [i] * 5 + [ctypes.c_float, i, p])
            lib.irt_attention_as_route.restype = i
            lib.irt_int4_screen_scores.argtypes = [p] * 5 + [i, i, ctypes.c_longlong, i, p]
            lib.irt_int4_screen_scores.restype = i
            lib.irt_int4_screen_scores_i8.argtypes = lib.irt_int4_screen_scores.argtypes
            lib.irt_int4_screen_scores_i8.restype = i
            lib.irt_int4_screen_plan.argtypes = [i, i, i, ctypes.c_longlong, i, i, i, p]
            lib.irt_int4_screen_plan.restype = i
            f = ctypes.c_float
            lib.irt_fused_all_metrics.argtypes = [p] * 6 + [i] * 3 + [p]
            lib.irt_fused_all_metrics.restype = i
            lib.irt_fused_optimized_scores.argtypes = [p] * 7 + [i] * 3 + [p]
            lib.irt_fused_optimized_scores.restype = i
            lib.irt_fused_optimized_scores_int8.argtypes = (
                [p] * 6 + [i] * 3 + [f] * 5 + [i, p])
            lib.irt_fused_optimized_scores_int8.restype = i
            lib.irt_int8_sweep_plan.argtypes = [i] * 6 + [p]
            lib.irt_int8_sweep_plan.restype = i
            lib.irt_fused_optimized_topk.argtypes = (
                [p] * 4 + [i] + [p] * 3 + [i] * 5 + [f] * 5 + [i, p])
            lib.irt_fused_optimized_topk.restype = i
            lib.irt_f32_sweep_plan.argtypes = [i] * 8 + [p]
            lib.irt_f32_sweep_plan.restype = i
            lib.irt_gemm_plan.argtypes = [i, i, i, i, i, p]
            lib.irt_gemm_plan.restype = i
            lib.irt_gemm_max_blocks.argtypes = [i]
            lib.irt_gemm_max_blocks.restype = i
            lib.irt_ln_cast.argtypes = [p] * 4 + [i] * 3 + [p]
            lib.irt_ln_cast.restype = i
            lib.irt_gemm_bf16.argtypes = [p] * 5 + [i] * 4 + [p]
            lib.irt_gemm_bf16.restype = i
            lib.irt_gemm_s8.argtypes = [p] * 7 + [i] * 5 + [p]
            lib.irt_gemm_s8.restype = i
            lib.irt_rowquant_gemm_plan.argtypes = [i, i, i, p]
            lib.irt_rowquant_gemm_plan.restype = i
            lib.irt_rowquant_gemm_max_clusters.argtypes = [i, i, i]
            lib.irt_rowquant_gemm_max_clusters.restype = i
            lib.irt_gemm_s8_gelu_rowquant.argtypes = [p] * 8 + [i] * 3 + [p]
            lib.irt_gemm_s8_gelu_rowquant.restype = i
            lib.irt_ln_rowquant.argtypes = [p] * 5 + [i] * 4 + [p]
            lib.irt_ln_rowquant.restype = i
            lib.irt_error_string.argtypes = [i]
            lib.irt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
