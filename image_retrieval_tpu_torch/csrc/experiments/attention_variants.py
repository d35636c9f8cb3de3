#!/usr/bin/env python3
"""The bf16 attention's wgmma form (csrc/attention_sm90.cuh, under K10 and
the attention step of K1, K2a, K8, K9a, K11) beside variants of it, on one
CUDA card. Not part of the library or of chip_smoke.py's checks: a design
experiment.

    python3 image_retrieval_tpu_torch/csrc/experiments/attention_variants.py \
        [--rates | SASS_PATH | --only design,phase-clocks,...]

Copies csrc/ under .smoke_tree/attention_variants/<name>/ (listed in
.gitignore) with attention_sm90.cuh edited as VARIANTS says, builds each
copy's multihead_attention.cu alone into a library (one nvcc per copy, all
at once), and times irt_attention_as_route's wgmma form (route 4) of every
copy in turns at L/14's image batch (B = 128, T = 257, W = 1024, 16 heads,
bf16), by CUDA events and by the kernel's device time (torch.profiler);
the mma.sync form (route 2) of the design's copy beside them. Then the
opcode counts of the design's kernel (cuobjdump -sass; with a path as the
argument, its whole SASS written there) and the SM clock. With --rates
only the cycles each instruction kind of the softmax costs on its own
(softmax_pipe_rates.cu beside this file). Variants that take
work away compute wrong outputs: none is checked, each only times."""

import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))  # the checkout
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402

CSRC = os.path.join(ROOT, "image_retrieval_tpu_torch", "csrc")
OUT = os.path.join(ROOT, ".smoke_tree", "attention_variants")
SHAPE = (128, 257, 1024, 16)

# Stand-ins for the products: cheap register work in place of each wgmma, so
# that the softmax runs on values the compiler cannot fold.
FAKE_PRODUCTS = """
template <int kN>
__device__ __forceinline__ void attn_qk_fake(float* d, uint64_t da, uint64_t db) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) d[i] = (float)(((int)(da ^ db) + i) & 255) * 0.01f;
}
template <bool kAcc>
__device__ __forceinline__ void attn_pv_fake(float* d, const uint32_t* a, uint64_t db) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = (kAcc ? d[i] : 0.f) + __uint_as_float(a[i & 3] & 0x3f00ffffu);
}

// Keeps the compiler's reads"""

# Clocks per phase of each tile (clock64, summed over every warp of every
# block into g_att_clk, read by irt_attention_phase_clocks): waits for K and
# V, waits for Q, QK^T with its barrier, passes 1-2 (max, exp, sum), pass 3
# with PV, the output.
PHASE_CLOCKS = (
    ("namespace {\n\nconstexpr int kWgHeadDim",
     "namespace {\n\n__device__ unsigned long long g_att_clk[8];\n\nconstexpr int kWgHeadDim"),
    ("  int f = 0, own = 0, n = 0;  // flat tiles, this warpgroup's tiles, items",
     "  int f = 0, own = 0, n = 0;\n  long long ck[6] = {0, 0, 0, 0, 0, 0}, t_;"),
    ("    mbar_wait(kv_full0 + 8 * s, (n >> 1) & 1);",
     "    t_ = clock64(); mbar_wait(kv_full0 + 8 * s, (n >> 1) & 1); ck[0] += clock64() - t_;"),
    ("      mbar_wait(q_full0 + 8 * stage, (own >> 1) & 1);",
     "      t_ = clock64(); mbar_wait(q_full0 + 8 * stage, (own >> 1) & 1);\n"
     "      ck[1] += clock64() - t_; t_ = clock64();"),
    ("      if (leader) load_q();\n",
     "      if (leader) load_q();\n      ck[2] += clock64() - t_; t_ = clock64();\n"),
    ("        // 3. p = e / sum, rounded to bf16, and 4",
     "        ck[3] += clock64() - t_; t_ = clock64();\n        // 3. p = e / sum, rounded to bf16, and 4"),
    ("      attn_fence<32>(o);\n      attn_hold(pa);",
     "      attn_fence<32>(o);\n      attn_hold(pa);\n      ck[4] += clock64() - t_; t_ = clock64();"),
    ("    // the warpgroup's products have read",
     "    ck[5] += clock64() - t_;\n    // the warpgroup's products have read"),
    ("      load_kv(n + 2);\n    }\n  }\n}",
     "      load_kv(n + 2);\n    }\n  }\n  if (lane == 0) {\n"
     "    for (int i = 0; i < 6; ++i) atomicAdd(&g_att_clk[i], (unsigned long long)ck[i]);\n"
     "    atomicAdd(&g_att_clk[6], 1ull);\n  }\n}"),
    ("multihead_attention.cu", "}  // extern \"C\"",
     "int irt_attention_phase_clocks(void* dst, int reset) {\n"
     "  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  if (reset) return (int)cudaMemcpyToSymbol(g_att_clk, z, sizeof z);\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_att_clk, sizeof z);\n}\n\n}  // extern \"C\""),
)
PHASES = ("wait K, V", "wait Q", "QK^T + barrier", "passes 1-2 (max, exp, sum)",
          "pass 3 + PV (live warps)", "output")

# name -> ((text of attention_sm90.cuh, its replacement) or (file, text,
# replacement), ...), applied in order
VARIANTS = {
    "design": (),
    # the products, loads and barriers alone: no softmax, p = 0
    "no-softmax": (("      if (wrow < seq) {", "      if (wrow < 0) {"),),
    # the softmax, loads and barriers alone: no wgmma
    "no-products": (("\n// Keeps the compiler's reads", FAKE_PRODUCTS),
                    ("attn_qk<kN, false>(sc.s[c], ", "attn_qk_fake<kN>(sc.s[c], "),
                    ("          attn_qk<kN, true>(sc.s[c], ", "          (void)("),
                    ("attn_pv<false>(o, ", "attn_pv_fake<false>(o, "),
                    ("attn_pv<true>(o, ", "attn_pv_fake<true>(o, ")),
    # the exponential as one multiply (wrong values): what expf costs
    "no-expf": (("e = attn_exp8(__fsub_rn(e, mx[r]));", "e = __fsub_rn(e, mx[r]) * 1.0001f;"),),
    # the quotient as one multiply by the reciprocal (wrong bits)
    "no-division": (("p[j] = kExact ? __fdiv_rn(e, sum[r]) : div_rn_by(e, sum[r], inv[r]);",
                     "p[j] = kExact ? __fdiv_rn(e, sum[r]) : e * inv[r];"),),
    # the design with its phases clocked
    "phase-clocks": PHASE_CLOCKS,
}


def build(name, edits):
    """The copy's csrc/ with the edits, and the nvcc process building its
    multihead_attention.cu into lib.so."""
    from image_retrieval_tpu_torch.ops import _build

    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d, ignore=shutil.ignore_patterns("experiments"))
    for edit in edits:
        fname, old, new = edit if len(edit) == 3 else ("attention_sm90.cuh", *edit)
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not in {fname} once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
           os.path.join(d, "multihead_attention.cu"), "-o", os.path.join(d, "lib.so")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def opcode_counts(lib):
    """{opcode: count} in the SASS of attention_wgmma_kernel<kN, false>."""
    from image_retrieval_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True).stdout
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = re.search(r"attention_wgmma_kernelILi1[34][46]ELb0E", line) is not None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] += 1
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: needs a CUDA card")
    card = c.card_line()
    if sys.argv[1:] == ["--rates"]:  # the instruction kinds' costs alone
        c.run_experiment(card, "softmax_pipe_rates", "softmax pipe rates")
        return
    only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else None
    procs = {name: build(name, edits) for name, edits in VARIANTS.items()
             if only is None or name in only}
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log[-4000:]}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"variant {name} ptxas (attention kernels): {' | '.join(regs[-4:])}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        p_, i_ = ctypes.c_void_p, ctypes.c_int
        lib.irt_attention_as_route.argtypes = (
            [p_] * 3 + [ctypes.c_longlong, p_] + [i_] * 5 + [ctypes.c_float, i_, p_])
        lib.irt_attention_as_route.restype = i_
        libs[name] = lib

    b, t, w, heads = SHAPE
    q, k, v = c.mha_inputs(torch, b, t, w, 5, torch.bfloat16)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, route):
        rc = lib.irt_attention_as_route(q.data_ptr(), k.data_ptr(), v.data_ptr(), w,
                                        out.data_ptr(), b, t, w, heads, 0,
                                        ctypes.c_float((w // heads) ** -0.5), route, stream)
        if rc != 0:
            raise SystemExit(f"attention_variants: launch failed ({rc})")

    fns = {name: (lambda lib=lib: call(lib, 4)) for name, lib in libs.items()}
    fns["mma.sync form (route 2)"] = lambda: call(libs["design"], 2)
    ms = {name: [] for name in fns}
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    for rnd in range(8):  # in turns: every form once a round, the order reversed every other
        order = list(fns) if rnd % 2 == 0 else list(reversed(fns))
        for name in order:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _r in range(10):
                fns[name]()
            e.record()
            e.synchronize()
            ms[name].append(s.elapsed_time(e) / 10)
    for name, fn in fns.items():
        med = sorted(ms[name])[len(ms[name]) // 2]
        print(f"attention variant {name}: {med:.4f} ms (CUDA events, median of 8 rounds), "
              f"device {c.device_ms(torch, fn)} ms, B={b} T={t} W={w} heads={heads} "
              f"[{card}]", flush=True)
    if len(sys.argv) > 1 and not sys.argv[1].startswith("--"):  # the design's SASS
        from image_retrieval_tpu_torch.ops import _build

        cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
        with open(sys.argv[1], "w") as f:
            f.write(subprocess.run([cuobjdump, "-sass", os.path.join(OUT, "design", "lib.so")],
                                   capture_output=True, text=True).stdout)
    if "phase-clocks" in libs:  # where a warp's cycles go, per tile
        lib = libs["phase-clocks"]
        buf = (ctypes.c_ulonglong * 8)()
        lib.irt_attention_phase_clocks(buf, 1)
        calls = 10
        for _ in range(calls):
            fns["phase-clocks"]()
        torch.cuda.synchronize()
        lib.irt_attention_phase_clocks(buf, 0)
        warps, tiles = buf[6], calls * b * heads * -(-t // 64) * 4
        total = sum(buf[:6])
        print(f"phase clocks: {warps} consumer warps over {calls} calls, "
              f"{tiles} warp tiles; cycles a warp tile: " + ", ".join(
                  f"{PHASES[i]} {buf[i] / tiles:.0f} ({buf[i] / total:.1%})" for i in range(6)),
              flush=True)
    counts = opcode_counts(os.path.join(OUT, "design", "lib.so"))
    total = sum(counts.values())
    top = ", ".join(f"{op} {n}" for op, n in counts.most_common(24))
    print(f"attention_wgmma_kernel<136 and 144, false> SASS: {total} instructions; {top}",
          flush=True)
    # the clock the card ran the kernel at, then what each instruction kind
    # of the softmax costs on its own (softmax_pipe_rates.cu)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True)
    for _ in range(200):
        fns["design"]()
    print(f"SM clock after the timing (now, max): {clocks.stdout.strip()}", flush=True)


if __name__ == "__main__":
    main()
