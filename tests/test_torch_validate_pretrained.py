"""The port's pretrained-checkpoint validation
(image_retrieval_tpu_torch/app/validate_pretrained.py) and the workflow's
one-time gate (app/workflow.py ``_maybe_validate_weights``) held against the
JAX package's (tools/validate_pretrained.py, app/workflow.py:163-236) on the
tiny checkpoint of tests/test_e2e_workflow_parity.py (a random
transformers.CLIPModel with the fixture vocabulary).

The tool runs on the CPU here (``main(argv, device="cpu")``): port, the
tokenizer probe, the serving tower (K1's plain version) against the plain
tower, the workflow over a synthetic dataset. Its results.json against the
JAX tool's over the same dataset within tests/test_torch_workflow.py's
limits: embeddings within 1e-4, full-chain MI within 0.05."""

import hashlib
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")

from image_retrieval_tpu_torch.analysis import plots  # noqa: E402
from image_retrieval_tpu_torch.app import validate_pretrained as tool  # noqa: E402
from image_retrieval_tpu_torch.app import workflow  # noqa: E402

from tests.test_e2e_workflow_parity import _tiny_checkpoint  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMB_ATOL = 1e-4  # tests/test_torch_workflow.py's limits
CHAIN_MI_ATOL = 0.05


def _jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import validate_pretrained

        return validate_pretrained
    finally:
        sys.path.pop(0)


def _npz(path):
    with np.load(path, allow_pickle=True) as z:
        return z["embeddings"].item()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _tiny_checkpoint(tmp_path_factory.mktemp("ckpt"))[1]


@pytest.fixture
def no_plots(monkeypatch):
    """Skip drawing (slow on the CPU; analysis/plots.py has its own tests)."""
    monkeypatch.setattr(plots, "available", lambda: False)
    monkeypatch.setattr("image_retrieval_tpu.analysis.plots.make_all", lambda an, out: {})


def test_full_chain_on_the_cpu_and_against_the_jax_tool(ckpt, tmp_path, no_plots, caplog,
                                                        monkeypatch):
    out = str(tmp_path / "val_run")
    served = []
    real = tool._check_serving
    monkeypatch.setattr(tool, "_check_serving",
                        lambda config, **kw: served.append(real(config, **kw)) or served[-1])
    with caplog.at_level(logging.INFO, logger="validate_pretrained"):
        rc = tool.main([ckpt, "--synthetic", "--output-dir", out, "--report-only",
                        "--check-serving"], device="cpu")
    assert rc == 0
    results_json = os.path.join(out, "analysis_results", "results.json")
    assert os.path.exists(results_json)
    assert len(served) == 1 and 0.98 <= served[0] <= 1.0 + 1e-6
    logged = " ".join(r.getMessage() for r in caplog.records)
    for line in ("checkpoint config: vision 224x224/32 w64 L2, text w32 L2",
                 "tokenizer ok: vocab loaded from checkpoint",
                 "serving-tower consistency on ported weights"):
        assert line in logged
    with open(results_json) as f:
        got = json.load(f)

    # the JAX tool on the dataset the port built: the same checkpoint, the
    # same images
    jout = str(tmp_path / "jax_run")
    data = os.path.join(out, "color_dataset")
    assert _jax_tool().main([ckpt, "--dataset-dir", data, "--output-dir", jout,
                             "--report-only"]) == 0
    with open(os.path.join(jout, "analysis_results", "results.json")) as f:
        want = json.load(f)
    assert got.keys() == want.keys()
    for part in ("general_mi", "color_mi"):
        assert got[part].keys() == want[part].keys()
        for metric, mi in want[part].items():
            assert got[part][metric] == pytest.approx(mi, abs=CHAIN_MI_ATOL), (part, metric)
    emb_t = _npz(os.path.join(out, "color_embeddings.npz"))
    emb_j = _npz(os.path.join(jout, "color_embeddings.npz"))
    assert len(emb_t) == len(emb_j) == 150
    key = lambda p: os.path.relpath(p, data)
    mine = {key(p): e for p, e in emb_t.items()}
    for p, e in emb_j.items():
        np.testing.assert_allclose(mine[key(p)], e, rtol=0, atol=EMB_ATOL)

    # the port's own results as the reference: the self-diff passes a tight gate
    out2 = str(tmp_path / "val_run2")
    assert tool.main([ckpt, "--dataset-dir", data, "--output-dir", out2,
                      "--reference-results", results_json, "--atol", "1e-9"],
                     device="cpu") == 0


def test_rejects_missing_vocab(tmp_path):
    """JAX tests/test_validate_pretrained.py:73."""
    _, ckpt_dir, _ = _tiny_checkpoint(tmp_path)
    os.remove(os.path.join(ckpt_dir, "vocab.json"))
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        tool.main([ckpt_dir, "--synthetic", "--output-dir", str(tmp_path / "x")],
                  device="cpu")
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        _jax_tool().main([ckpt_dir, "--synthetic", "--output-dir", str(tmp_path / "y")])


def test_needs_a_dataset_option(ckpt):
    with pytest.raises(SystemExit) as e:
        tool.main([ckpt], device="cpu")
    assert e.value.code == 2


@pytest.mark.parametrize("case", ["equal", "off", "missing"])
def test_diff_table_equals_the_jax_tools(case, capsys):
    ref = {"general_mi": {"cosine_distance": 0.31, "l2_distance": 0.2},
           "color_mi": {"cosine_distance": 0.12},
           "optimal_weights": {"w_angle": 1.0, "w_l1": 0.0}}
    ours = json.loads(json.dumps(ref))
    if case == "off":
        ours["general_mi"]["l2_distance"] = 0.2071
        ours["optimal_weights"]["w_l1"] = 0.5
    if case == "missing":
        del ours["color_mi"]["cosine_distance"]
    got = tool._diff_table(ours, ref, 5e-3)
    printed = capsys.readouterr().out
    want = _jax_tool()._diff_table(ours, ref, 5e-3)
    assert got == want and printed == capsys.readouterr().out
    assert "worst |delta|" in printed
    assert got == {"equal": 0.0, "off": 0.5, "missing": float("inf")}[case]


# ---------------------------------------------------------------------------
# The workflow's one-time gate
# ---------------------------------------------------------------------------


def _blob_dir(tmp_path, content=b"weights"):
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    (ckpt_dir / "pytorch_model.bin").write_bytes(content)
    out = tmp_path / "out"
    return ckpt_dir, out


def test_gate_runs_the_tool_once_and_writes_the_marker(tmp_path, monkeypatch):
    ckpt_dir, out = _blob_dir(tmp_path)
    runs = []

    def fake_run(cmd, **kw):
        runs.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="ok\n", stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    workflow._maybe_validate_weights(str(ckpt_dir), str(out))
    assert len(runs) == 1
    cmd = runs[0]
    assert cmd[1:4] == ["-m", "image_retrieval_tpu_torch.app.validate_pretrained",
                        str(ckpt_dir)]
    assert {"--synthetic", "--check-serving", "--report-only"} <= set(cmd)
    assert cmd[cmd.index("--output-dir") + 1] == os.path.join(str(out), "pretrained_validation")
    blob = ckpt_dir / "pytorch_model.bin"
    st = os.stat(blob)
    assert (out / ".validated_weights").read_text().split() == [
        hashlib.sha256(b"weights").hexdigest(), f"stat:{blob}:7:{int(st.st_mtime)}"]

    # the stat tag: no hash, no tool
    spy = []
    real_sha = hashlib.sha256
    monkeypatch.setattr(hashlib, "sha256", lambda *a: spy.append(1) or real_sha(*a))
    workflow._maybe_validate_weights(str(ckpt_dir), str(out))
    assert spy == [] and len(runs) == 1

    # touched: the stat tag misses, the hash matches, the tag is refreshed
    os.utime(blob, (st.st_atime + 100, st.st_mtime + 100))
    workflow._maybe_validate_weights(str(ckpt_dir), str(out))
    assert spy == [1] and len(runs) == 1
    assert (out / ".validated_weights").read_text().count("stat:") == 2
    workflow._maybe_validate_weights(str(ckpt_dir), str(out))
    assert spy == [1]

    # new bytes: the tool runs again
    blob.write_bytes(b"other weights")
    workflow._maybe_validate_weights(str(ckpt_dir), str(out))
    assert len(runs) == 2


def test_gate_without_a_blob_warns(tmp_path, caplog):
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    with caplog.at_level(logging.WARNING):
        workflow._maybe_validate_weights(str(ckpt_dir), str(tmp_path / "out"))
    assert any("skipping validation" in r.message for r in caplog.records)


def test_gate_exits_when_the_tool_fails(tmp_path):
    """The real tool in a child process, on a checkpoint without its
    vocabulary: the child fails, the gate raises SystemExit and writes no
    marker."""
    _, ckpt_dir, _ = _tiny_checkpoint(tmp_path)
    os.remove(os.path.join(ckpt_dir, "vocab.json"))
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="validation FAILED"):
        workflow._maybe_validate_weights(ckpt_dir, str(out))
    assert not (out / ".validated_weights").exists()


def test_the_jax_gate_passes_no_dataset_option(ckpt, tmp_path):
    """The divergence ROADMAP.md queue 3 records: the JAX workflow runs its
    tool with the checkpoint alone (app/workflow.py:226), which the tool's
    argument parser refuses with exit code 2, so a new checkpoint always
    fails the JAX gate; the port's gate passes a dataset option."""
    with pytest.raises(SystemExit) as e:
        _jax_tool().main([ckpt])
    assert e.value.code == 2
    assert "--synthetic" in workflow._validation_command(ckpt, str(tmp_path))
