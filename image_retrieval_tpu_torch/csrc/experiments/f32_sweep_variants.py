#!/usr/bin/env python3
"""The f32 metric sweep's design (csrc/f32_sweep_sm90.cuh, under K4, K6 and
K7) beside the variants it was chosen over, on one CUDA card. Not part of
the library or of chip_smoke.py's checks: a design experiment.

    python3 image_retrieval_tpu_torch/csrc/experiments/f32_sweep_variants.py

First the instruction rates the design rests on (tf32_mma_rate.cu beside
this file). Then copies of the package under .smoke_tree/f32_variants/
(listed in .gitignore), each with the sweep's header edited as F32_VARIANTS
says, built all at once (one nvcc per copy), and timed in turns with the
design (design, variants, design): K6, K7, K4 over phase 6's seeded
1,001,344 x 512 f32 gallery (chip_smoke.f32_gallery), by CUDA events and by
the sweep kernel's device time. The variants take the products away, the
differences away, both (the ring, the queries, the epilogue and K4's merges
alone), use stages of one box, split by cvt.rna.tf32.f32, or prefetch the
block's next tiles into L2. No variant is checked: each only times."""

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))  # the checkout
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402

HEADER = os.path.join("image_retrieval_tpu_torch", "csrc", "f32_sweep_sm90.cuh")

# name -> (text of the header, its replacement), applied in order
F32_VARIANTS = {
    "no-products": (("      if constexpr (kDot) {", "      if constexpr (kDot && false) {"),),
    "no-differences": (("      if constexpr (kDiff) {", "      if constexpr (kDiff && false) {"),),
    "neither": (("      if constexpr (kDot) {", "      if constexpr (kDot && false) {"),
                ("      if constexpr (kDiff) {", "      if constexpr (kDiff && false) {")),
    "one-box-stages": (("constexpr int kFsStageTarget = 8192;", "constexpr int kFsStageTarget = 1;"),),
    "cvt-splits": (("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                    "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
                    "  return r;"),),
    "l2-prefetch": (("""                            (b0 + j) * p.box_dims, tile * p.tile_rows);
              }
""", """                            (b0 + j) * p.box_dims, tile * p.tile_rows);
              }
              const int ahead = tile + (p.tile_rows <= 32 ? 2 : 1) * gridDim.x;
              for (int j = 0; ahead < p.tiles && j < nb; ++j) {
                asm volatile(
                    "cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];"
                    ::"l"(reinterpret_cast<uint64_t>(&map)), "r"((b0 + j) * p.box_dims),
                    "r"(ahead * p.tile_rows) : "memory");
              }
"""),),
}


def time_f32_sweep(card, label):
    """The sweep's kernels in this checkout, timed alone (CUDA events of the
    call, then the device time of the sweep's kernel), with no check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_retrieval_tpu_torch.ops import _build
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.load_library()
    g, m, q = c.f32_gallery(torch)
    w_all = torch.tensor(c.wtuple(c.W_ALL), device="cuda")
    w_cos, w_ref = c.wtuple(c.W_COS), c.wtuple(c.W_REF)
    cases = (("K6", 1, lambda q: fm.fused_all_metrics(q, g, m)),
             ("K6", 64, lambda q: fm.fused_all_metrics(q, g, m)),
             ("K7 all-live", 64, lambda q: fm.fused_optimized_scores(q, g, m, w_all)),
             ("K4 cosine-only", 1, lambda q: fm.fused_optimized_topk(q, g, m, w_cos)),
             ("K4 cosine-only", 64, lambda q: fm.fused_optimized_topk(q, g, m, w_cos)),
             ("K4 reference", 64, lambda q: fm.fused_optimized_topk(q, g, m, w_ref)))
    for name, nq, call in cases:
        qq = q[:nq].contiguous()
        fn = lambda: call(qq)  # noqa: E731
        ms = c.event_ms(torch, fn, samples=5, reps=2, warm=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and "f32_sweep_kernel" in e.key) / 5e3
        print(f"f32 sweep variant {label}: {name} Q={nq}: {ms:.4f} ms, sweep kernel {dev:.4f} "
              f"ms [{card}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("f32_sweep_variants: CUDA is not available")
    card = c.card_line()
    if sys.argv[1:2] == ["--time"]:  # inside one copy
        time_f32_sweep(card, sys.argv[2])
        return 0
    c.run_experiment(card, "tf32_mma_rate", "mma rates")
    root = os.path.join(ROOT, ".smoke_tree", "f32_variants")
    with open(os.path.join(ROOT, HEADER)) as f:
        source = f.read()
    names = ["design", *F32_VARIANTS]
    for name in names:
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "image_retrieval_tpu_torch"),
                        os.path.join(d, "image_retrieval_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
        text = source
        for old, new in F32_VARIANTS.get(name, ()):
            if old not in text:
                c.fail(f"f32 variant {name}: {old!r} is not in {HEADER}")
            text = text.replace(old, new)
        with open(os.path.join(d, HEADER), "w") as f:
            f.write(text)
    build = "from image_retrieval_tpu_torch.ops import _build; _build.build()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=os.path.join(root, n),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in names]
    for name, proc in zip(names, procs):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            c.fail(f"f32 variant {name} did not build:\n{out[-4000:]}")
    script = os.path.relpath(os.path.abspath(__file__), ROOT)
    for name in (*names, "design"):
        proc = subprocess.run([sys.executable, script, "--time", name],
                              cwd=os.path.join(root, name), capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            c.fail(f"f32 variant {name} failed:\n{proc.stderr[-4000:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
