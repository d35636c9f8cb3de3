"""The yardstick's arithmetic: the published peaks of one H100 SXM, the least
time a piece of work could take on them, and the operations of the CLIP
towers and the index sweeps, counted from shapes alone.

`bound`, `block_bound`, `sweep_slots`, `f32_bounds` and `k5_bounds` are a
frozen copy of the bound arithmetic of the repository's `chip_smoke.py`,
taking shapes where the original takes tensors. They stay here, where a
change to the program cannot move them: a kernel's share of its bound is
judged against the mathematics of the layer at the cell's shapes, whatever
kernel computes it.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM, dense rates without sparsity, at the
# full 700 W power limit.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
# TF32 on the tensor cores: an exact f32 product is counted as three TF32
# products (the split form of f32_bounds), 6 flops per multiply-add.
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# f32 outside the tensor cores: 67 TFLOP/s counts an FMA as two operations,
# so the CUDA cores complete 33.5e12 f32 operations a second.
PEAK_F32_SLOTS = 67e12 / 2
# bf16 outside the tensor cores is packed two to a lane: a bf16 subtract or
# max of one element takes half an f32 slot.
BF16_SLOT = 0.5

WEIGHT_KEYS = ("w_angle", "w_l1", "w_l2", "w_inf", "w_mag")


def wtuple(w) -> tuple:
    """A weight dict (or a 5-sequence) as the 5-tuple of floats."""
    if isinstance(w, dict):
        return tuple(float(w.get(k, 1.0 if k == "w_angle" else 0.0)) for k in WEIGHT_KEYS)
    return tuple(float(x) for x in w)


def bound(int8_ops: float, bf16_flops: float, nbytes: float, f32_slots: float = 0.0,
          tf32_flops: float = 0.0) -> dict:
    """The least time the card could take: {"bound_ms", "bound_by"}."""
    ops_ms = (int8_ops / PEAK_INT8_OPS + bf16_flops / PEAK_BF16_FLOPS
              + f32_slots / PEAK_F32_SLOTS + tf32_flops / PEAK_TF32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def block_bound(kind: str, b: int, t: int, w: int, hidden: int, causal: bool,
                act_bytes: float, weight_bytes: float, int8: bool = True) -> dict:
    """Bound of one call of a layer kernel or one of its halves ("layer",
    "attn", "mlp") on a (b, t, w) input. Operations: the projections (8 W^2
    per token in the attention half, 4 W hidden in the MLP half) at the int8
    peak (the bf16 peak without int8), and the attention's QK^T and PV (4 hd
    per query-key pair and head; with the causal mask only the pairs j <= i)
    at the bf16 peak. Bytes: the input and the output (`act_bytes` each) and
    every weight, scale and bias once (`weight_bytes`)."""
    m = b * t
    pairs = t * (t + 1) // 2 if causal else t * t
    proj = flops = 0.0
    if kind in ("layer", "attn"):
        proj += 8.0 * w * w * m
        flops += 4.0 * b * pairs * w
    if kind in ("layer", "mlp"):
        proj += 4.0 * w * hidden * m
    nbytes = 2 * act_bytes + weight_bytes
    return bound(proj, flops, nbytes) if int8 else bound(0.0, proj + flops, nbytes)


def sweep_slots(w, int8: bool = False, tensor: bool = False) -> float:
    """f32 CUDA-core slots per (query, row, dim) of the weighted score under
    weights `w` (None: every term): one FMA for the product where the cosine
    or the Gram-form L2 is live; where L1 or Linf is live one subtract, then
    one add for L1 and one max for Linf. Over int8 rows (K5) the product and
    the L1 sum are tensor-core work and the subtract and max are bf16
    operations at the packed rate. `tensor`: the product runs on the tensor
    cores in split TF32 and takes no slot here."""
    live = [True] * 5 if w is None else [x != 0.0 for x in wtuple(w)]
    slots = 0.0 if int8 or tensor or not (live[0] or live[2]) else 1.0
    if live[1] or live[3]:
        narrow = BF16_SLOT if int8 else 1.0
        slots += narrow + (1.0 if live[1] and not int8 else 0.0) + (narrow if live[3] else 0.0)
    return slots


def f32_bounds(w, nq: int, n: int, d: int, row_bytes: int, out_bytes: float,
               planes: bool = False):
    """The bound of an f32-row sweep (K4, K6, K7 in the program) and the bound
    as the program's early PRs counted it. Bytes: the rows (row_bytes a
    value), magnitudes, f32 queries and `out_bytes` of output once.
    Operations per (query, row, dim): sweep_slots(tensor=True) on the CUDA
    cores (and K6's direct-L2 FMA, `planes`); where the cosine or the L2 is
    live, the product in split TF32, 3 products of 2 flops over f32 rows, 2
    over bf16 rows."""
    live = [True] * 5 if w is None else [x != 0.0 for x in wtuple(w)]
    el = float(nq) * n * d
    nbytes = n * (d * row_bytes + 4) + nq * d * 4 + out_bytes
    extra = 1.0 if planes else 0.0
    tf32 = (6.0 if row_bytes == 4 else 4.0) * el if live[0] or live[2] else 0.0
    new = bound(0.0, 0.0, nbytes, (sweep_slots(w, tensor=True) + extra) * el, tf32)
    old = bound(0.0, 0.0, nbytes, (sweep_slots(w) + extra) * el)
    return new, old


def k5_bounds(w, nq: int, n: int, d: int):
    """The int8 weighted sweep's (K5's) bound on these shapes, and the bound
    as counted before. Bytes: the int8 rows, scales, magnitudes, f32 queries
    and the (Q, N) f32 output once. Operations per (query, row, dim):
    sweep_slots(int8=True) on the CUDA cores; at the bf16 tensor-core peak 2
    for the product where the cosine or the L2 is live and 2 for the L1 sum
    where L1 is."""
    live = [x != 0.0 for x in wtuple(w)]
    el = float(nq) * n * d
    nbytes = n * (d + 4 + 4) + nq * d * 4 + nq * n * 4
    dot = 2.0 * el if live[0] or live[2] else 0.0
    new = bound(0.0, dot + (2.0 * el if live[1] else 0.0), nbytes, sweep_slots(w, True) * el)
    old = bound(0.0, dot, nbytes, (sweep_slots(w, True) + (1.0 if live[1] else 0.0)) * el)
    return new, old


# -- the benchmark's own counts, built on the copies above --------------------


def tower_work(model: dict, tower: str, n: int) -> dict:
    """Operations of one forward of `n` examples through a tower of the
    configuration's `model` widths: {"int8": ops, "bf16": flops, "tf32":
    flops}. The projections of every layer are int8 work under int8_matmuls
    (bf16 otherwise), the attention's QK^T and PV bf16, the vision patch
    embedding a bf16 product, the final projection an f32 product counted
    in the split-TF32 form (6 flops a multiply-add)."""
    if tower == "vision":
        w, layers = model["vision_width"], model["vision_layers"]
        patches = (model["image_size"] // model["patch_size"]) ** 2
        t, causal = patches + 1, False
        patch_flops = 2.0 * n * patches * model["patch_size"] ** 2 * 3 * w
    else:
        w, layers = model["text_width"], model["text_layers"]
        t, causal, patch_flops = model["context_length"], True, 0.0
    hidden = 4 * w
    pairs = t * (t + 1) // 2 if causal else t * t
    proj = layers * (8.0 * w * w + 4.0 * w * hidden) * n * t
    attn = layers * 4.0 * n * pairs * w
    int8 = bool(model.get("int8_matmuls"))
    return {"int8": proj if int8 else 0.0,
            "bf16": attn + patch_flops + (0.0 if int8 else proj),
            "tf32": 6.0 * n * w * model["embed_dim"]}


def seconds_at_peak(work: dict) -> float:
    """The time `work` ({"int8", "bf16", "tf32"}) takes at the peak of each
    type."""
    return (work.get("int8", 0.0) / PEAK_INT8_OPS + work.get("bf16", 0.0) / PEAK_BF16_FLOPS
            + work.get("tf32", 0.0) / PEAK_TF32_FLOPS)


def sweep_work(tier: str, weights, nq: int, n: int, d: int) -> dict:
    """The tensor-core products of one group's sweep (the matmuls, no CUDA-core
    slots): f32 rows in the split-TF32 form; int8 rows bf16 x int8 products,
    and K5's L1 sum where L1 is live. `weights` None: the cosine."""
    el = float(nq) * n * d
    live = [True, False, False, False, False] if weights is None else [
        x != 0.0 for x in wtuple(weights)]
    dot = live[0] or live[2]
    if tier == "float32":
        return {"tf32": 6.0 * el if dot else 0.0}
    return {"bf16": (2.0 * el if dot else 0.0) + (2.0 * el if live[1] else 0.0)}


def sweep_bound(tier: str, weights, nq: int, n: int, d: int) -> dict:
    """The least time of one group's sweep over `n` rows, as the copies above
    count it: f32 rows by f32_bounds (rows and magnitudes read once, the
    queries; no output bytes, since a sweep that returns the top-k need not
    write its scores), int8 rows under weights by k5_bounds (whose bytes hold
    K5's (Q, N) f32 score plane as well), and the int8 cosine by its bf16 x
    int8 products over the rows, their scales and the queries. `weights`
    None: the cosine."""
    if tier == "float32":
        return f32_bounds(weights or {"w_angle": 1.0}, nq, n, d, 4, 0.0)[0]
    if weights is not None:
        return k5_bounds(weights, nq, n, d)[0]
    return bound(0.0, 2.0 * nq * n * d, float(n) * (d + 4) + nq * d * 4)
