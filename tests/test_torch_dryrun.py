"""The port's dryrun_multichip (image_retrieval_tpu_torch/dryrun.py) on
virtual CPU devices: every sharded path once, each held against its plain
answer inside the dry run, with the JAX dry run's OK lines
(__graft_entry__.py:50-408)."""

import re

import pytest
import torch

from image_retrieval_tpu_torch import dryrun

# the tags of the JAX dry run's lines, in its order
TAGS = ["", "index", "approx-select", "streamed", "journal", "int4", "int4-pallas", "ivf",
        "screen", "multislice", "pipelined", "serving"]


def _tags(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK")]
    return [m.group(1) or "" for m in
            (re.match(r"dryrun_multichip OK(?: \(([a-z0-9-]+)\))?:", ln) for ln in lines)]


def test_dryrun_multichip_8(capsys):
    dryrun.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert _tags(out) == TAGS
    assert "mesh={'data': 4, 'model': 2}" in out
    assert "mesh=(slice=2, data=4)" in out and "mesh=(data=4, pipe=2)" in out


def test_dryrun_an_odd_mesh_leaves_out_the_paired_layouts(capsys):
    """3 devices: no model axis, no (slice, data) or (data, pipe) mesh, as in
    the JAX dry run."""
    dryrun.main(["3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert _tags(out) == [t for t in TAGS if t not in ("multislice", "pipelined")]
    assert "mesh={'data': 3, 'model': 1}" in out


def test_dryrun_devices():
    assert dryrun.dryrun_devices(4, "cpu") == [torch.device("cpu")] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.dryrun_devices(4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.dryrun_multichip(4)
