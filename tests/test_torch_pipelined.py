"""The pipelined (data, pipe) trainer (train/pipelined.py) on meshes of
virtual CPU devices, held against the JAX PipelinedCLIPTrainer on the same
layouts of the conftest's virtual devices, against the JAX plain trainer
and against the port's one-device trainer, from the same parameters
(params_from_jax) on the same numpy batches.

Limits are the JAX tests' (tests/test_pipelined.py): losses rtol 1e-4;
parameters after one plain SGD step, leaf by leaf in the split layout,
rtol 2e-3 and atol 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from image_retrieval_tpu.config import MeshConfig as JaxMeshConfig
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image_retrieval_tpu.train import pipelined as jpipelined
from image_retrieval_tpu.train import trainer as jtrainer
from image_retrieval_tpu_torch.models.weights import params_from_jax
from image_retrieval_tpu_torch.parallel.mesh import Mesh
from image_retrieval_tpu_torch.train import CLIPTrainer, PipelinedCLIPTrainer
from image_retrieval_tpu_torch.train import data as tdata
from image_retrieval_tpu_torch.train.pipelined import split_clip_params
from tests.test_models import tiny_model_config

LAYOUTS = [(4, 2), (2, 2), (1, 2)]


def pipe_mesh(data, pipe):
    grid = np.empty((data, pipe), dtype=object)
    grid[:] = "cpu"
    return Mesh(grid, ("data", "pipe"))


def _batch(n=8, t=16, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    return px, rng.integers(1, 100, size=(n, t)).astype(np.int32)


def _flat(tree, prefix=""):
    """A JAX subtree -> {port name: array} (dots, token_embedding unwrapped)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return {k.replace("token_embedding.embedding", "token_embedding"): v for k, v in out.items()}


def _split_as_numpy(split):
    return {g: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else {k: t.detach().numpy() for k, t in v.items()}) for g, v in split.items()}


def _jax_split(jsplit):
    return {g: (np.asarray(v) if g == "logit_scale" else _flat(v)) for g, v in jsplit.items()}


@pytest.fixture(scope="module")
def tiny_params():
    _, params = jax_init_params(tiny_model_config(), seed=0)
    return jax.tree.map(np.asarray, params)


def _ours(params, layout, cfg=None, **kw):
    cfg = cfg or tiny_model_config()
    return PipelinedCLIPTrainer(cfg, pipe_mesh(*layout), num_micro=2,
                                params=params_from_jax(params, cfg), **kw)


@pytest.fixture(scope="module")
def plain_losses(tiny_params):
    cfg = tiny_model_config()
    tr = CLIPTrainer(cfg, params=params_from_jax(tiny_params, cfg), device="cpu")
    px, toks = _batch()
    return [tr.train_step(px, toks) for _ in range(2)]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_losses_match_the_jax_pipelined_and_the_plain_trainer(layout, tiny_params,
                                                               plain_losses):
    px, toks = _batch()
    data, pipe = layout
    jmesh = JaxMesh(np.array(jax.devices()[: data * pipe]).reshape(data, pipe),
                    ("data", "pipe"))
    jt = jpipelined.PipelinedCLIPTrainer(cfg=tiny_model_config(), mesh=jmesh, num_micro=2,
                                         params=jax.tree.map(jnp.array, tiny_params))
    want = [jt.train_step(px, toks) for _ in range(2)]
    tt = _ours(tiny_params, layout)
    got = [tt.train_step(px, toks) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, plain_losses, rtol=1e-4)
    assert got[1] < got[0]


@pytest.fixture(scope="module")
def sgd_split(tiny_params):
    """One SGD step of the JAX plain trainer and of the port's one-device
    trainer, each in the split layout."""
    cfg = tiny_model_config()
    px, toks = _batch()
    jt = jtrainer.CLIPTrainer(cfg=cfg, mesh=jax_make_mesh(JaxMeshConfig(data=8, model=1)),
                              params=jax.tree.map(jnp.array, tiny_params),
                              optimizer=optax.sgd(0.1))
    jt.train_step(px, toks)
    tt = CLIPTrainer(cfg, params=params_from_jax(tiny_params, cfg), device="cpu",
                     optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    tt.train_step(px, toks)
    return (_jax_split(jpipelined.split_clip_params(jax.device_get(jt.params), cfg)),
            _split_as_numpy(split_clip_params(tt.params, cfg)))


@pytest.mark.parametrize("layout", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_sgd_parameters_match_the_plain_trainers(layout, tiny_params, sgd_split):
    """The gradient is the true one: one SGD step moves every parameter as
    the plain trainers' step does (the JAX test's guard against the psum
    overcount)."""
    px, toks = _batch()
    tt = _ours(tiny_params, layout, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    tt.train_step(px, toks)
    got = _split_as_numpy(tt.params)
    for want in sgd_split:
        assert got.keys() == want.keys()
        for group in ("logit_scale", "ve", "vh", "te", "th", "vb", "tb"):
            g, w = got[group], want[group]
            if group == "logit_scale":
                np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-5)
                continue
            assert g.keys() == w.keys(), group
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-3, atol=2e-5,
                                           err_msg=f"{group}.{k}")


def test_split_clip_params_matches_jax_key_by_key(tiny_params):
    cfg = tiny_model_config()
    got = _split_as_numpy(split_clip_params(params_from_jax(tiny_params, cfg), cfg))
    want = _jax_split(jpipelined.split_clip_params(tiny_params, cfg))
    assert got.keys() == want.keys() == {"ve", "vb", "vh", "te", "tb", "th", "logit_scale"}
    for group, w in want.items():
        if group == "logit_scale":
            assert got[group].shape == () and np.array_equal(got[group], w)
            continue
        assert got[group].keys() == w.keys(), group
        for k in w:
            assert got[group][k].shape == w[k].shape and np.array_equal(got[group][k], w[k])
    assert got["vb"]["mlp.fc1.kernel"].shape[0] == cfg.vision_layers


def test_stages_hold_their_layers_and_the_rest_lives_once(tiny_params):
    tt = _ours(tiny_params, (2, 2))
    fc1 = tt._parts["vb"]["mlp.fc1.kernel"]
    assert [p.shape[0] for p in fc1] == [1, 1]  # 2 layers over 2 stages
    assert tt.shardings["vb"]["mlp.fc1.kernel"].devices == list(tt.mesh.devices[0])
    assert all(len(ps) == 1 for ps in tt._parts["ve"].values())
    params = tt.params
    assert params["vb"]["mlp.fc1.kernel"].shape[0] == 2 and params["logit_scale"].shape == ()


def test_short_token_batches(tiny_params):
    """Token batches shorter than context_length train: the causal mask
    follows the batch's own length, as in the towers."""
    cfg = tiny_model_config()
    px, short = _batch(t=8)
    tt = _ours(tiny_params, (2, 2))
    plain = CLIPTrainer(cfg, params=params_from_jax(tiny_params, cfg), device="cpu")
    for _ in range(2):
        loss = tt.train_step(px, short)
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, plain.train_step(px, short), rtol=1e-4)


def test_remat_equals_no_remat(tiny_params):
    cfg = tiny_model_config()
    px, toks = _batch()
    a = _ours(tiny_params, (2, 2), dataclasses.replace(cfg, remat=True))
    b = _ours(tiny_params, (2, 2))
    assert [a.train_step(px, toks) for _ in range(2)] == [b.train_step(px, toks)
                                                          for _ in range(2)]


def test_config_errors(tiny_params):
    cfg = tiny_model_config()
    with pytest.raises(ValueError, match="data and pipe"):
        PipelinedCLIPTrainer(cfg, None)
    grid = np.empty((2, 2), dtype=object)
    grid[:] = "cpu"
    with pytest.raises(ValueError, match="data and pipe"):
        PipelinedCLIPTrainer(cfg, Mesh(grid, ("data", "model")))
    with pytest.raises(ValueError, match="vision layers % stages"):
        PipelinedCLIPTrainer(cfg, pipe_mesh(1, 4))
    with pytest.raises(ValueError, match="inference-only"):
        PipelinedCLIPTrainer(dataclasses.replace(cfg, int8_matmuls=True), pipe_mesh(1, 2))
    tt = _ours(tiny_params, (2, 2))
    px, toks = _batch(n=6)
    with pytest.raises(ValueError, match="microbatches"):
        tt.train_step(px, toks)
    assert not hasattr(tt, "fit")


def test_finetune_on_color_dataset_through_the_pipelined_trainer(tmp_path, tiny_params):
    """train/data.py's loop for a trainer without fit: the pipelined trainer
    on a dataset the JAX package's prepare_color_dataset wrote, step for step
    the losses fit() gives the one-device trainer on the same batches."""
    from image_retrieval_tpu.data.dataset import prepare_color_dataset

    base = str(tmp_path / "ds")
    prepare_color_dataset(base_dir=base, num_examples=2)
    cfg = dataclasses.replace(tiny_model_config(), image_size=224, patch_size=32)
    _, params = jax_init_params(cfg, seed=0)
    state = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    pp = PipelinedCLIPTrainer(cfg, pipe_mesh(2, 2), num_micro=2, learning_rate=3e-4,
                              params=state)
    calls = []
    real = pp.train_step_async
    pp.train_step_async = lambda p, t: calls.append(1) or real(p, t)
    losses = tdata.finetune_on_color_dataset(pp, base, batch_size=16, steps=6)
    plain = CLIPTrainer(cfg, learning_rate=3e-4, params=state, device="cpu")
    want = tdata.finetune_on_color_dataset(plain, base, batch_size=16, steps=6)
    assert len(losses) == len(calls) == 6 and all(isinstance(v, float) for v in losses)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
