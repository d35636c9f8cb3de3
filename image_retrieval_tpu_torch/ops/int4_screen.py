"""The int4 screen kernels (K3, K12) and their plain PyTorch versions.

Port of ``image_retrieval_tpu/ops/pallas_kernels.py``'s int4 screen:
``_int4_screen_kernel`` (l.602) under ``int4_screen_scores_pallas`` (l.783)
and ``int4_screen_topc_pallas`` (l.800). For each query and gallery row

    score[q, n] = scale4[n] * sum_d bf16(qu[q, d]) * (nibble(packed[n], d) - 8)

in f32, over the plain (N, D/2) uint8 nibble rows of ``ops/int4.py``; rows
whose ``valid`` flag is False score -inf.

``int4_screen_scores`` launches the hand-written Hopper kernel
(csrc/int4_screen.cu over csrc/int4_screen_sm90.cuh: a persistent sweep, the
rows through a TMA ring, the queries resident in shared memory, the products
on the tensor cores) for CUDA tensors and runs
``int4_screen_scores_reference`` for CPU tensors; it never falls back from
the card to the plain version. ``int4_screen_plan`` mirrors the kernel's
launch plan.

The int8-query form (``_int4_screen_kernel_i8``, l.636, selected by
``qform="i8"`` at l.751): ``quantize_queries_i8`` is ``int4_query_planes_i8``
(l.664) without its TPU-only zero-extended planes, per query absmax / 127,
round half to even, clip to +-127; ``int4_screen_scores_i8`` computes

    score[q, n] = scale4[n] * float(sum_d q8[q, d] * (nibble(packed[n], d) - 8))

with an exact int32 sum and without the per-query scale, which
``int4_screen_topc(qform="i8")`` multiplies into the selected values, as the
JAX package does (l.876-882). Kernel and plain version agree bit for bit.

``int4_screen_topc`` sweeps a gallery in
segments of ``SEGMENT_ROWS`` rows and merges each segment's top-c, exact
with lowest-index ties (``ops/topk.py::exact_topk_wide``). The JAX
package's TPU selection is ``approx_max_k``; on the CPU that lowers to the
exact ``top_k``, which is what this selection reproduces.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from image_retrieval_tpu_torch.ops.fused_metrics import H100_SMS
from image_retrieval_tpu_torch.ops.int4 import segmented_topc, unpack2_dots

# Rows per kernel launch of int4_screen_topc: a (64, 2^21) f32 plane is
# 512 MiB, the largest device buffer of a search besides the gallery.
SEGMENT_ROWS = 1 << 21

# Kernel vs plain: both take exact products (bf16 x nibble) and sum them in
# f32, in other orders. For unit queries and unit rows at D <= 768 the raw
# dot stays below ~60 and the scale near 1/50, so reordered sums move a
# score by ~1e-6 at most; a swapped nibble order or a dropped scale moves
# it by ~1e-1 (tests/test_torch_int4.py shows both).
SCREEN_MAX_ABS = 1e-5


QFORMS = ("bf16", "i8")

# ---- the kernel's launch plan (csrc/int4_screen_sm90.cuh) --------------------
# Eight consumer warps and a producer warp a block, two blocks an SM for
# units of 8 or 16 queries, else one; a warp's unit is 32 rows, a tile 256; a
# stage is a tile's box of 128 packed bytes (256 dims); at most 16 stages;
# dynamic shared memory up to the SM's 227 KB shared by its blocks, less 1 KB
# a block for the barriers, the ring aligned to 1 KB; the epilogue parks 16
# queries (8 for 8-query units) of 32 rows at a pitch of 36 floats a warp.
SCREEN_WARPS, SCREEN_UNIT_ROWS, SCREEN_BOX_BYTES, SCREEN_MAX_STAGES = 8, 32, 128, 16
SCREEN_TILE_ROWS = SCREEN_WARPS * SCREEN_UNIT_ROWS
SCREEN_BOX_DIMS = 2 * SCREEN_BOX_BYTES
SCREEN_STAGE_BYTES = SCREEN_TILE_ROWS * SCREEN_BOX_BYTES
SCREEN_ALIGN, SMEM_PER_SM = 1024, 232448
SCREEN_EPI_QUERIES, SCREEN_EPI_PITCH = 16, SCREEN_UNIT_ROWS + 4
I8_MAX_DIM = 2048  # |sum| <= 127 * 8 * D stays below 2^24: exact in f32


@dataclass(frozen=True)
class Int4ScreenPlan:
    """The screen's launch plan: the fields of the C side's Int4ScreenPlan,
    in its order."""

    qw: int           # queries of a warp's unit: 8, 16, 32 or 64
    tile_rows: int    # rows of a tile: 256
    passes: int       # ceil(nq / qw)
    resident: int     # 1: every pass's queries over the whole of D loaded once per block
    q_rows: int       # query rows in shared memory
    q_boxes: int      # boxes of a query row in shared memory at once
    q_pitch: int      # bytes from one query row to the next
    boxes: int        # boxes of a packed row: ceil(D / 256)
    stages: int       # ring depth
    stage_bytes: int  # tile_rows * 128
    tma: int          # 1: TMA loads; 0: the producer warp copies
    tiles: int        # ceil(rows / tile_rows)
    per_sm: int       # blocks an SM: 2 for units of 8 or 16 queries, else 1
    grid: int         # persistent blocks: min(tiles, per_sm * SMs)
    smem: int         # dynamic shared memory of a block, bytes


def screen_smem_max(per_sm: int) -> int:
    """Dynamic shared memory a block may take beside its static barriers
    when per_sm blocks share an SM."""
    return SMEM_PER_SM // per_sm - 1024


def screen_epilogue_bytes(qw: int) -> int:
    """The epilogue's scratch: per consumer warp min(qw, 16) queries of 36 floats."""
    return SCREEN_WARPS * min(qw, SCREEN_EPI_QUERIES) * SCREEN_EPI_PITCH * 4


def screen_uses_wgmma(qform: str, qw: int) -> bool:
    """Units whose products run on wgmma: bf16 queries, 64 a unit."""
    return qform == "bf16" and qw == 64


def screen_q_row_bytes(q_boxes: int, qform: str, qw: int) -> int:
    """A query row of q_boxes boxes in shared memory: for mma.sync 64 mod
    128 bytes in bf16 and 32 mod 128 in int8, so that the B fragments' reads
    of neighbouring query rows hit distinct banks; for wgmma unpadded (the
    rows are 128-byte slices of swizzled 64-dim tiles)."""
    if screen_uses_wgmma(qform, qw):
        return q_boxes * SCREEN_BOX_DIMS * 2
    if qform == "i8":
        return q_boxes * SCREEN_BOX_DIMS + 32
    return q_boxes * SCREEN_BOX_DIMS * 2 + 64


def int4_screen_plan(nq: int, d: int, rows: int, row_offset: int = 0, aligned: bool = True,
                     qform: str = "bf16", sms: int = H100_SMS) -> Int4ScreenPlan:
    """How the screen sweeps nq queries against `rows` packed rows of d dims
    from row `row_offset` on, on a card of `sms` SMs; `aligned`: the packed
    base is 16-byte aligned; qform "bf16" (K3) or "i8" (K12). A warp's unit
    is 32 rows x the fewest of 8, 16, 32 or 64 queries that hold nq; more
    than 64 queries take further passes over each tile. Two blocks share an
    SM for units of 8 or 16 queries, one takes it for 32 or 64; 64-query
    units of bf16 queries run their products on wgmma. Every pass's
    queries stay in shared memory where they fit beside two stages and the
    epilogue's scratch, else one pass's over as many boxes as fit (reloaded
    per tile and pass); the ring takes the rest. TMA loads where the row
    stride and base allow ((D/2) % 16 == 0, aligned) and row coordinates fit
    an int, else the producer warp copies. Raises ValueError only for a
    shape neither form takes: nq, rows or d below 1, an odd d, a negative
    offset, d > 2048 with int8 queries."""
    if qform not in QFORMS:
        raise ValueError(f"int4_screen_plan: qform must be one of {QFORMS}, got {qform!r}")
    return _screen_plan(int(nq), int(d), int(rows), int(row_offset), bool(aligned),
                        qform, int(sms))


@functools.lru_cache(maxsize=256)
def _screen_plan(nq, d, rows, row_offset, aligned, qform, sms) -> Int4ScreenPlan:
    if (nq < 1 or d < 2 or d % 2 or rows < 1 or row_offset < 0 or sms < 1
            or (qform == "i8" and d > I8_MAX_DIM)):
        raise ValueError(f"the int4 screen takes nq, rows >= 1, an even d >= 2 (<= "
                         f"{I8_MAX_DIM} with int8 queries) and row_offset >= 0: nq={nq}, "
                         f"d={d}, rows={rows}, row_offset={row_offset}, qform={qform}")
    rb = d // 2
    qw = 8 if nq <= 8 else 16 if nq <= 16 else 32 if nq <= 32 else 64
    passes = -(-nq // qw)
    boxes = -(-rb // SCREEN_BOX_BYTES)
    per_sm = 2 if qw <= 16 else 1
    smem_max = screen_smem_max(per_sm)
    epi = screen_epilogue_bytes(qw)
    room = smem_max - SCREEN_ALIGN - epi - 2 * SCREEN_STAGE_BYTES
    if passes * qw * screen_q_row_bytes(boxes, qform, qw) <= room:
        resident, q_rows, q_boxes = 1, passes * qw, boxes
    else:
        pad = screen_q_row_bytes(0, qform, qw)
        fit = (room // qw - pad) // (screen_q_row_bytes(1, qform, qw) - pad)
        resident, q_rows, q_boxes = 0, qw, min(fit, boxes)
    q_pitch = screen_q_row_bytes(q_boxes, qform, qw)
    q_bytes = q_rows * q_pitch
    stages = min(SCREEN_MAX_STAGES,
                 (smem_max - SCREEN_ALIGN - q_bytes - epi) // SCREEN_STAGE_BYTES)
    tma = int(aligned and rb % 16 == 0 and row_offset + rows <= 0x7FFFFFFF)
    tiles = -(-rows // SCREEN_TILE_ROWS)
    return Int4ScreenPlan(qw, SCREEN_TILE_ROWS, passes, resident, q_rows, q_boxes, q_pitch,
                          boxes, stages, SCREEN_STAGE_BYTES, tma, tiles, per_sm,
                          min(tiles, per_sm * sms),
                          SCREEN_ALIGN + stages * SCREEN_STAGE_BYTES + q_bytes + epi)


def _check(qu, packed, scales, valid, row_offset, rows):
    if qu.dim() != 2 or packed.dim() != 2 or packed.dtype != torch.uint8:
        raise ValueError("int4_screen_scores takes (Q, D) queries and (N, D/2) "
                         "uint8 packed rows")
    n, half = packed.shape
    if qu.shape[1] != 2 * half:
        raise ValueError(f"int4_screen_scores: queries of dim {qu.shape[1]} for "
                         f"packed rows of {half} bytes (dim {2 * half})")
    if scales.shape != (n,) or valid.shape != (n,):
        raise ValueError(f"int4_screen_scores: scales {tuple(scales.shape)} and "
                         f"valid {tuple(valid.shape)} must be ({n},)")
    if scales.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("int4_screen_scores: scales must be float32, valid bool")
    if not 0 <= row_offset <= row_offset + rows <= n:
        raise ValueError(f"int4_screen_scores: segment [{row_offset}, "
                         f"{row_offset + rows}) outside {n} rows")


def int4_screen_scores_reference(qu: torch.Tensor, packed: torch.Tensor,
                                 scales: torch.Tensor, valid: torch.Tensor,
                                 row_offset: int = 0, rows=None) -> torch.Tensor:
    """Plain PyTorch version: ``unpack2_dots(qu, packed) * scales`` over the
    segment [row_offset, row_offset + rows), invalid rows -inf. (Q, rows) f32."""
    rows = packed.shape[0] - row_offset if rows is None else rows
    _check(qu, packed, scales, valid, row_offset, rows)
    seg = slice(row_offset, row_offset + rows)
    s = unpack2_dots(qu, packed[seg]) * scales[seg]
    return s.masked_fill(~valid[seg], float("-inf"))


def _launch(entry, symbol, queries, packed, scales, valid, row_offset, rows):
    """One launch of the library's `symbol` (either screen entry: the same
    arguments) on PyTorch's current stream, counted on the wrapper `entry`;
    raises on operands the kernel does not take and on a refused launch (a
    shape its plan refuses among them)."""
    from image_retrieval_tpu_torch.ops._build import load_library

    for name, a in (("queries", queries), ("packed", packed), ("scales", scales),
                    ("valid", valid)):
        if a.device != packed.device or not a.is_contiguous():
            raise ValueError(f"{entry.__name__} kernel: {name} must be contiguous on "
                             f"{packed.device}")
    out = torch.empty((queries.shape[0], rows), dtype=torch.float32, device=packed.device)
    if queries.shape[0] == 0 or rows == 0:
        return out
    lib = load_library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = getattr(lib, symbol)(
            queries.data_ptr(), packed.data_ptr(), scales.data_ptr(), valid.data_ptr(),
            out.data_ptr(), queries.shape[0], queries.shape[1], row_offset, rows, stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} kernel failed: "
                           + lib.irt_error_string(rc).decode())
    entry.launches += 1
    return out


def _int4_screen_scores_cuda(qu, packed, scales, valid, row_offset, rows):
    if qu.dtype != torch.bfloat16:
        raise TypeError(f"int4_screen kernel takes bfloat16 queries, got {qu.dtype}")
    if qu.data_ptr() % 4:
        raise ValueError("int4_screen kernel: queries must be 4-byte aligned")
    return _launch(int4_screen_scores, "irt_int4_screen_scores", qu, packed, scales, valid,
                   row_offset, rows)


def int4_screen_scores(qu: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor, valid: torch.Tensor,
                       row_offset: int = 0, rows=None) -> torch.Tensor:
    """Screen scores of the gallery segment [row_offset, row_offset + rows):
    (Q, rows) f32, -inf where ``valid`` is False.

    qu: (Q, D) bf16 unit queries; packed: (N, D/2) uint8; scales: (N,) f32;
    valid: (N,) bool. A CUDA tensor goes through the Hopper kernel (or this
    raises); a CPU tensor takes the plain version.
    ``int4_screen_scores.launches`` counts kernel launches."""
    rows = packed.shape[0] - row_offset if rows is None else rows
    _check(qu, packed, scales, valid, row_offset, rows)
    if packed.device.type == "cuda":
        return _int4_screen_scores_cuda(qu, packed, scales, valid, row_offset, rows)
    if packed.device.type == "cpu":
        return int4_screen_scores_reference(qu, packed, scales, valid, row_offset, rows)
    raise ValueError(f"int4_screen_scores: unsupported device {packed.device}")


int4_screen_scores.launches = 0


def quantize_queries_i8(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) f32 or bf16 queries -> ((Q, D) int8, (Q, 1) f32 scales): the
    symmetric per-query quantization of int4_query_planes_i8, bit for bit.
    The divisors are tensors: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which is not the rounded quotient."""
    qf = queries.to(torch.float32)
    amax = torch.clamp(qf.abs().amax(1, keepdim=True), min=1e-12)
    qs = amax / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(qf / qs), -127, 127).to(torch.int8), qs


def int4_screen_scores_i8_reference(q8: torch.Tensor, packed: torch.Tensor,
                                    scales: torch.Tensor, valid: torch.Tensor,
                                    row_offset: int = 0, rows=None) -> torch.Tensor:
    """Plain PyTorch version of the int8-query screen over the segment
    [row_offset, row_offset + rows): float(int dot) * scales, invalid rows
    -inf, (Q, rows) f32. The dot is summed in float64, which is exact for
    integers of this size on any device (|sum| <= 127 * 8 * D)."""
    rows = packed.shape[0] - row_offset if rows is None else rows
    _check(q8, packed, scales, valid, row_offset, rows)
    seg = slice(row_offset, row_offset + rows)
    q = q8.to(torch.float64)
    lo = ((packed[seg] & 0xF).to(torch.int16) - 8).to(torch.float64)
    hi = ((packed[seg] >> 4).to(torch.int16) - 8).to(torch.float64)
    dots = q[:, 0::2] @ lo.t() + q[:, 1::2] @ hi.t()
    s = dots.to(torch.float32) * scales[seg]
    return s.masked_fill(~valid[seg], float("-inf"))


def _int4_screen_scores_i8_cuda(q8, packed, scales, valid, row_offset, rows):
    if q8.shape[1] > I8_MAX_DIM:
        raise ValueError(f"int4_screen i8 kernel: D <= {I8_MAX_DIM} keeps the int32 sum "
                         f"exact in f32, got {q8.shape[1]}")
    return _launch(int4_screen_scores_i8, "irt_int4_screen_scores_i8", q8, packed, scales,
                   valid, row_offset, rows)


def int4_screen_scores_i8(q8: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor, valid: torch.Tensor,
                          row_offset: int = 0, rows=None) -> torch.Tensor:
    """The int8-query screen of the gallery segment [row_offset, row_offset
    + rows): (Q, rows) f32 = float(int32 dot) * scales, -inf where ``valid``
    is False, without the queries' own scales.

    q8: (Q, D) int8 (``quantize_queries_i8``); the rest as
    ``int4_screen_scores``. A CUDA tensor goes through the Hopper kernel (or
    this raises); a CPU tensor takes the plain version.
    ``int4_screen_scores_i8.launches`` counts kernel launches."""
    rows = packed.shape[0] - row_offset if rows is None else rows
    _check(q8, packed, scales, valid, row_offset, rows)
    if q8.dtype != torch.int8:
        raise TypeError(f"int4_screen_scores_i8 takes int8 queries, got {q8.dtype}")
    if packed.device.type == "cuda":
        return _int4_screen_scores_i8_cuda(q8, packed, scales, valid, row_offset, rows)
    if packed.device.type == "cpu":
        return int4_screen_scores_i8_reference(q8, packed, scales, valid, row_offset, rows)
    raise ValueError(f"int4_screen_scores_i8: unsupported device {packed.device}")


int4_screen_scores_i8.launches = 0


def int4_screen_topc(qu: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                     valid: torch.Tensor, c: int, seg_rows: int = SEGMENT_ROWS,
                     qform: str = "bf16") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-c of the int4 screen over the whole gallery: one
    ``int4_screen_scores`` call per segment of `seg_rows` rows, each
    segment's exact top-c merged into a running list (lowest index first
    among ties). Returns (scores f32, indices int64), each (Q, min(c, N));
    -inf entries are padding (fewer valid rows than c).

    qform "i8" quantizes the queries to int8 once, screens every segment
    with ``int4_screen_scores_i8`` and multiplies the selected values by the
    queries' scales (positive, so no ranking changes; -inf stays -inf)."""
    if qform not in QFORMS:
        raise ValueError(f"int4_screen_topc: qform must be one of {QFORMS}, got {qform!r}")
    if qform == "i8":
        q8, qs = quantize_queries_i8(qu)
        vals, idx = segmented_topc(
            lambda off, rows: int4_screen_scores_i8(q8, packed, scales, valid, off, rows),
            packed.shape[0], c, seg_rows)
        return vals * qs, idx

    def seg(off, rows):
        return int4_screen_scores(qu, packed, scales, valid, off, rows)

    return segmented_topc(seg, packed.shape[0], c, seg_rows)
