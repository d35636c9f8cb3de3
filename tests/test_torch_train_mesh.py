"""The port's CLIPTrainer over a (data, model) mesh of 8 virtual CPU devices
held against the JAX CLIPTrainer on the conftest's 8 virtual devices, on the
same layouts, with the same parameters (params_from_jax) and the same numpy
batches, and against the port's one-device trainer.

Tolerances are those of tests/test_torch_train.py: losses of three AdamW
steps at rtol 1e-4; parameters after plain SGD (never after AdamW, whose
first step is lr * g / |g|) leaf by leaf at rtol 2e-4, atol 4e-6.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_retrieval_tpu.config import MeshConfig as JaxMeshConfig
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image_retrieval_tpu.train import trainer as jtrainer
from image_retrieval_tpu_torch.config import MeshConfig
from image_retrieval_tpu_torch.models import clip as tclip
from image_retrieval_tpu_torch.models.weights import params_from_jax, params_to_jax
from image_retrieval_tpu_torch.parallel.mesh import Mesh, make_mesh
from image_retrieval_tpu_torch.train import CLIPTrainer
from image_retrieval_tpu_torch.train.trainer import _param_spec, param_shardings
from tests.test_models import tiny_model_config

LAYOUTS = [(8, 1), (4, 2), (2, 4)]
TRAIN_FLAGS = dict(fused_attn_block=True, fused_mlp_block=True, fused_train_vjp=True)


def cpu_mesh(data, model):
    return make_mesh(MeshConfig(data=data, model=model), devices=["cpu"] * (data * model))


def _batch(n=8, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 100, size=(n, 16)).astype(np.int32)
    toks[:, 0], toks[:, -1] = 49406, 49407
    return px, toks


@pytest.fixture(scope="module")
def tiny_params():
    _, params = jax_init_params(tiny_model_config(), seed=0)
    return jax.tree.map(np.asarray, params)


def _jax_trainer(layout, params, **kw):
    data, model = layout
    return jtrainer.CLIPTrainer(cfg=tiny_model_config(),
                                mesh=jax_make_mesh(JaxMeshConfig(data=data, model=model)),
                                params=jax.tree.map(jnp.array, params), **kw)


def _trainer(params, cfg=None, **kw):
    cfg = cfg or tiny_model_config()
    return CLIPTrainer(cfg, params=params_from_jax(params, cfg), **kw)


@pytest.fixture(scope="module")
def one_device_losses(tiny_params):
    tr = _trainer(tiny_params, learning_rate=1e-3, device="cpu")
    px, toks = _batch()
    return [tr.train_step(px, toks) for _ in range(3)]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_adamw_losses_match_the_jax_trainer_on_the_same_layout(layout, tiny_params,
                                                                one_device_losses):
    px, toks = _batch()
    jt = _jax_trainer(layout, tiny_params, learning_rate=1e-3)
    tt = _trainer(tiny_params, learning_rate=1e-3, mesh=cpu_mesh(*layout))
    assert tt._parts is not None and tt.mesh.shape == {"data": layout[0], "model": layout[1]}
    want = [jt.train_step(px, toks) for _ in range(3)]
    got = [tt.train_step(px, toks) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, one_device_losses, rtol=1e-4)
    assert got[2] < got[0]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sgd_parameters_match_the_jax_trainer(layout, tiny_params):
    """One plain SGD step on both sides: every parameter leaf by leaf
    (through params_to_jax of the gathered state dict); the gradient the
    port's graph gives over the shards is the true one, with no rescaling."""
    cfg = tiny_model_config()
    px, toks = _batch()
    jt = _jax_trainer(layout, tiny_params, optimizer=optax.sgd(0.1))
    tt = _trainer(tiny_params, mesh=cpu_mesh(*layout),
                  optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    np.testing.assert_allclose(tt.train_step(px, toks), jt.train_step(px, toks), rtol=1e-4)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jt.params))[0]
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(tt.params, cfg))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    start = jax.tree_util.tree_leaves(tiny_params)
    moved = 0
    for (path, g), (_, w), s in zip(got, want, start):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=4e-6, err_msg=str(path))
        moved += bool(np.abs(w - s).max() > 1e-6)
    assert moved >= len(want) - 4


def _port_key(path) -> str:
    """A JAX parameter path -> the port's state-dict key (models/weights.py)."""
    key = ".".join(str(getattr(k, "key", k)) for k in path[1:])  # under "params"
    key = re.sub(r"block_(\d+)", r"blocks.\1", key)
    return key.replace("token_embedding.embedding", "token_embedding")


def test_param_shardings_follow_the_jax_rules_key_by_key(tiny_params):
    state = params_from_jax(tiny_params, tiny_model_config())
    want = {_port_key(path): tuple(jtrainer._param_spec(path, leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tiny_params)[0]}
    assert {k: _param_spec(k, v) for k, v in state.items()} == want
    split = [k for k, spec in want.items() if spec]
    assert len(split) == 4 * (4 * 2 + 2)  # a layer: q/k/v/fc1 kernels + biases, out/fc2
    shardings = param_shardings(state, cpu_mesh(2, 4))
    assert shardings.keys() == state.keys()
    assert shardings["vision.blocks.0.mlp.fc1.kernel"].spec == (None, "model")
    assert shardings["vision.blocks.0.mlp.fc2.kernel"].spec == ("model", None)
    assert shardings["text.blocks.1.attn.q_proj.bias"].spec == ("model",)
    assert shardings["logit_scale"].spec == () and shardings["logit_scale"].parts == 1


def test_tp_params_actually_sharded(tiny_params):
    """The counterpart of tests/test_train.py::test_tp_params_actually_sharded:
    on (2, 4) each fc1 kernel is held as 4 column parts and each fc2 kernel
    as 4 row parts, one a model shard, homed at the mesh positions (0, j);
    replicated parameters once, at the mesh's first device."""
    mesh = cpu_mesh(2, 4)
    tr = _trainer(tiny_params, mesh=mesh)
    w = tiny_model_config().vision_width
    fc1 = tr._parts["vision.blocks.0.mlp.fc1.kernel"]
    fc2 = tr._parts["vision.blocks.0.mlp.fc2.kernel"]
    assert [tuple(p.shape) for p in fc1] == [(w, w)] * 4
    assert [tuple(p.shape) for p in fc2] == [(w, w)] * 4
    assert tr.shardings["vision.blocks.0.mlp.fc1.kernel"].devices == list(mesh.devices[0])
    assert len({p.data_ptr() for p in fc1 + fc2}) == 8
    assert len(tr._parts["vision.pre_ln.scale"]) == 1
    n_leaves = sum(len(ps) for ps in tr._parts.values())
    assert len(tr.optimizer.param_groups[0]["params"]) == n_leaves
    full = params_from_jax(tiny_params, tiny_model_config())
    assert all(torch.equal(tr.params[k], full[k]) for k in full)


def test_plain_route_splits_the_projections_and_kernel_routes_gather(tiny_params, monkeypatch):
    """Under (4, 2) the plain layers never run whole (their Block.forward is
    not called); under the training kernel configuration every layer runs
    whole once a data shard (the kernel entries called 4 shards x 4 layers a
    pass) and the losses stay those of one device."""
    px, toks = _batch()
    calls = {"block": 0, "attention_block_train": 0, "mlp_block": 0}
    real_forward = tclip.Block.forward

    def forward(self, *a, **k):
        calls["block"] += 1
        return real_forward(self, *a, **k)

    monkeypatch.setattr(tclip.Block, "forward", forward)
    for name in ("attention_block_train", "mlp_block"):
        real = getattr(tclip, name)
        monkeypatch.setattr(tclip, name, lambda *a, _r=real, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _r(*a, **k))[1])
    tr = _trainer(tiny_params, learning_rate=1e-3, mesh=cpu_mesh(4, 2))
    tr.train_step(px, toks)
    assert calls == {"block": 0, "attention_block_train": 0, "mlp_block": 0}
    cfg = dataclasses.replace(tiny_model_config(), **TRAIN_FLAGS)
    got = _trainer(tiny_params, cfg, learning_rate=1e-3, mesh=cpu_mesh(4, 2))
    want = _trainer(tiny_params, cfg, learning_rate=1e-3, device="cpu")
    for _ in range(2):
        np.testing.assert_allclose(got.train_step(px, toks), want.train_step(px, toks),
                                   rtol=1e-4)
    # two steps on the mesh (4 shards) and two on one device, 4 layers each
    assert calls["attention_block_train"] == calls["mlp_block"] == 2 * 4 * 4 + 2 * 4


@pytest.mark.parametrize("layout", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_int8_kernel_route_over_a_mesh_matches_one_device(layout, tiny_params):
    """int8_matmuls through the whole-layer kernel (straight-through) on a
    mesh: each data shard runs whole layers; the losses those of one
    device."""
    cfg = dataclasses.replace(tiny_model_config(), int8_matmuls=True, fused_layer_block=True)
    px, toks = _batch()
    got = _trainer(tiny_params, cfg, learning_rate=1e-3, mesh=cpu_mesh(*layout))
    want = _trainer(tiny_params, cfg, learning_rate=1e-3, device="cpu")
    for _ in range(2):
        np.testing.assert_allclose(got.train_step(px, toks), want.train_step(px, toks),
                                   rtol=1e-4)


def test_remat_over_a_mesh_equals_no_remat(tiny_params):
    px, toks = _batch()
    cfg = tiny_model_config()
    a = _trainer(tiny_params, dataclasses.replace(cfg, remat=True), mesh=cpu_mesh(2, 4))
    b = _trainer(tiny_params, cfg, mesh=cpu_mesh(2, 4))
    assert a.train_step(px, toks) == b.train_step(px, toks)
    assert a.train_step(px, toks) == b.train_step(px, toks)


def test_checkpoint_round_trip_on_2x2(tmp_path, tiny_params):
    """A mesh trainer from another seed, restored, takes the next step to the
    same loss; the checkpoint is the one-device layout, so a device= trainer
    restores it too, and a mesh trainer restores a device= trainer's."""
    cfg = tiny_model_config()
    px, toks = _batch()
    tr = CLIPTrainer(cfg, seed=0, mesh=cpu_mesh(2, 2))
    tr.train_step(px, toks)
    path = str(tmp_path / "ckpt.pt")
    tr.save_checkpoint(path)
    loss_before = tr.train_step(px, toks)
    tr2 = CLIPTrainer(cfg, seed=1, mesh=cpu_mesh(2, 2))
    tr2.restore_checkpoint(path)
    assert tr2.train_step(px, toks) == pytest.approx(loss_before, abs=1e-6)
    assert tr2.train_step(px, toks) == pytest.approx(tr.train_step(px, toks), abs=1e-6)
    for k, v in tr.params.items():
        torch.testing.assert_close(tr2.params[k], v, rtol=0, atol=1e-6)
    one = CLIPTrainer(cfg, seed=2, device="cpu")
    one.restore_checkpoint(path)
    assert one.train_step(px, toks) == pytest.approx(loss_before, abs=1e-5)
    one.save_checkpoint(path)
    tr3 = CLIPTrainer(cfg, seed=3, mesh=cpu_mesh(2, 2))
    tr3.restore_checkpoint(path)
    np.testing.assert_allclose(tr3.train_step(px, toks), one.train_step(px, toks), rtol=1e-5)


def test_a_device_trainer_is_the_one_device_path(tiny_params):
    """device= (and a one-device mesh) keep the model as it is: a live
    module on the device, its own parameters in the optimizer, the same
    losses bit for bit."""
    px, toks = _batch()
    a = _trainer(tiny_params, device="cpu")
    b = _trainer(tiny_params, mesh=make_mesh(devices=["cpu"]))
    for tr in (a, b):
        assert tr._parts is None and tr.device == torch.device("cpu")
        assert next(tr.model.parameters()).device.type == "cpu"
    assert [a.train_step(px, toks) for _ in range(2)] == [b.train_step(px, toks)
                                                          for _ in range(2)]


def test_mesh_errors(tiny_params):
    cfg = tiny_model_config()
    with pytest.raises(ValueError, match="not both"):
        CLIPTrainer(cfg, device="cpu", mesh=cpu_mesh(2, 1))
    grid = np.empty(2, dtype=object)
    grid[:] = "cpu"
    with pytest.raises(ValueError, match="data, model"):
        CLIPTrainer(cfg, mesh=Mesh(grid, ("data",)))
    tr = CLIPTrainer(cfg, mesh=cpu_mesh(4, 1))
    px, toks = _batch(n=6)
    with pytest.raises(ValueError, match="do not split"):
        tr.train_step(px, toks)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CLIPTrainer(cfg)
