"""The benchmark of `image_retrieval_tpu_torch` on NVIDIA GPUs: one run of one
cell of BENCHMARK.json.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is found by name, in files of its own:

- the cell (`workloads` in BENCHMARK.json) names a configuration and a
  traffic mix, and its correctness limits are `bench_port/cells/<cell>.json`;
- a configuration is `bench_port/configs/<config>.json`;
- a traffic mix is `bench_port/traffic/<traffic>.json`, whose `kind` names
  the driver that runs it, `bench_port/drivers/<kind>.py`;
- a metric (end-to-end or per layer) is read by
  `bench_port/metrics/<metric>.py`, a module with `read(run)` that returns
  the number, or None where the run holds nothing to read.

A driver's `run(ctx)` does the set-up, the warm-up, the measured window
(and in a traced run the profiled sub-window), then checks what the timed
path produced against the reference in `bench_port/reference/` and returns
a `Run` (below). The result is one JSON line on standard output, after the
compared numbers and their limits on standard error.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# top-level module names the benchmark's process may not hold once the window
# has closed: JAX and the JAX package (the port's own name begins with it, so
# names are compared whole, up to the first dot)
FORBIDDEN = ("jax", "jaxlib", "flax", "image_retrieval_tpu")


def load_benchmark(path: str = os.path.join(REPO, "BENCHMARK.json")) -> dict:
    with open(path) as f:
        return json.load(f)


def data(kind: str, name: str) -> dict:
    """bench_port/<kind>/<name>.json: a configuration, a traffic mix or a
    cell's limits."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    """bench_port/<kind>/<name>.py, loaded by path: a driver or a metric."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_port.{kind}." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Names in sys.modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN)


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def model_config(model: dict):
    """The program's ModelConfig for a configuration's `model` section."""
    import dataclasses

    from image_retrieval_tpu_torch.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return dataclasses.replace(ModelConfig(), **{k: v for k, v in model.items() if k in fields})


class Run(SimpleNamespace):
    """What a driver hands back. Always: `attempted`, `failed`, `checks`
    ({name: (value, limit)}), `memory_peak_bytes`, `setup_s`, `window_s`.
    A search driver: `answered`, `latency_spans` ((call, answer) host
    times of each answered request), `stats` (the server's
    counters over the window), and in a traced run `encodes` / `sweeps`
    ((host time, size, ...) of each call over the window). An ingest driver:
    `images`, `batch`, `host_ms` (per batch inside encode_stream), and in a
    traced run `dispatched` (host times of the batches dispatched). A traced
    run: `trace` (profiling.TraceSummary) and `profiler`."""


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, t_process: float, config=None, traffic=None, limits=None,
             build_s=None):
    """One run of cell `workload`; returns (result dict, stderr check lines).
    `config`, `traffic` and `limits` replace the cell's files (the tests run
    tiny shapes on the CPU through this). `build_s`: the seconds of set-up
    spent building (a checkout's first run) or loading the program's kernel
    library, reported apart as `setup_build_s` and counted in setup_s too."""
    cell = find(bench["workloads"], workload, "workload")
    config = config or data("configs", cell["config"])
    traffic = traffic or data("traffic", cell["traffic"])
    limits = limits or data("cells", workload)["limits"]
    ctx = SimpleNamespace(cell=cell, config=config, traffic=traffic, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace), device=device,
                          t_process=t_process, model_config=model_config(config["model"]))
    run = module("drivers", traffic["kind"]).run(ctx)
    run.config = config

    section = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for m in section:
        if not applies(m, workload):
            continue
        v = module("metrics", m["name"]).read(run)
        if v is None:
            continue
        if not math.isfinite(v):
            raise ValueError(f"metric {m['name']} read {v}")
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    checks, correct = {}, run.failed == 0 and run.attempted > 0
    for name, value in run.checks.items():
        if name not in limits:
            raise KeyError(f"no limit for the check {name!r} in cells/{workload}.json")
        checks[name] = {"value": value, "limit": limits[name]}
        correct = correct and math.isfinite(value) and value <= limits[name]
    dev = {"platform": "gpu" if str(device).startswith("cuda") else str(device),
           "kind": device_name(device), "count": int(cell["chips"]),
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    lines = [f"note {n}" for n in getattr(run, "notes", [])]
    if build_s is not None:
        result["setup_build_s"] = float(build_s)
        lines.append(f"note kernel library built or loaded in {build_s:.3f} s (inside setup_s)")
    result["checks"] = checks
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    lines.append(f"check attempted {run.attempted} failed {run.failed}")
    return result, lines


def device_name(device) -> str:
    import torch

    if str(device).startswith("cuda"):
        return torch.cuda.get_device_name(torch.device(device))
    return str(device)


def main(argv, t_process: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cell = find(bench["workloads"], args.workload, "workload")

    import torch

    if not torch.cuda.is_available():
        print("bench_port: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench_port: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from image_retrieval_tpu_torch.ops._build import load_library

    t = time.perf_counter()
    load_library()  # builds csrc/ into the package's _build/ on a checkout's first run
    build_s = time.perf_counter() - t
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda:0", t_process, build_s=build_s)
    found = forbidden_modules()
    if found:
        print(f"bench_port: the process holds JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
