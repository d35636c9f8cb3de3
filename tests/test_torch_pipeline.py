"""GPipe (parallel/pipeline.py): the port's gpipe_apply on a 4-stage pipe
mesh of virtual CPU devices against the JAX gpipe_apply on the conftest's
4-device pipe mesh and against sequential_apply, on a stack of 8 plain
blocks (width 32, 4 heads) carried over from the JAX blocks' parameters.

Limits are the JAX test's own (tests/test_pipeline.py): forward 1e-5,
gradients 1e-4. The gradients of that test's loss, sum(out ** 2), reach ~1e3
a leaf, and two f32 programs that sum in different orders part by about 1e-6
of a leaf's largest gradient (at most 1.1e-6 measured, where a value
cancels to near zero); so against the JAX gradients the limit also carries
F32_SUM_SCALE of that largest gradient. Against the port's own sequential
run, which sums in the same order, it is the JAX test's limit alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from image_retrieval_tpu.models.clip import Block as JaxBlock
from image_retrieval_tpu.parallel import pipeline as jpipe
from image_retrieval_tpu_torch.models.clip import PLAIN, Block
from image_retrieval_tpu_torch.parallel.mesh import Mesh
from image_retrieval_tpu_torch.parallel.pipeline import (
    gpipe_apply,
    sequential_apply,
    shard_stages,
    stack_layer_params,
)

WIDTH, HEADS, LAYERS, STAGES = 32, 4, 8, 4
F32_SUM_SCALE = 2e-6  # of a leaf's largest gradient (module docstring)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def stack():
    """The JAX stack (tests/test_pipeline.py's fixture) and the same layers
    as port state dicts."""
    block = JaxBlock(WIDTH, HEADS, jnp.float32)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((2, 6, WIDTH))
    layers = [block.init(jax.random.fold_in(key, i), x0)["params"] for i in range(LAYERS)]
    ours = [{k: torch.from_numpy(v.copy()) for k, v in _flat(jax.device_get(p)).items()}
            for p in layers]
    return block, jpipe.stack_layer_params(layers), ours


def _pipe_mesh():
    grid = np.empty(STAGES, dtype=object)
    grid[:] = "cpu"
    return Mesh(grid, ("pipe",))


def _jax_pipe_mesh():
    return JaxMesh(np.array(jax.devices()[:STAGES]), ("pipe",))


def _apply_layer():
    with torch.device("meta"):
        blk = Block(WIDTH, HEADS, False, (PLAIN, PLAIN))
    assert sorted(k for k, _ in blk.named_parameters()) == sorted(
        _flat(jax.device_get(JaxBlock(WIDTH, HEADS).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, WIDTH)))["params"])))
    return lambda p, x: torch.func.functional_call(blk, p, (x, torch.float32, None))


def _micro(m, seed):
    return np.random.default_rng(seed).normal(size=(m, 2, 6, WIDTH)).astype(np.float32)


@pytest.mark.parametrize("m", [6, 1], ids=["6_microbatches", "one_microbatch"])
def test_forward_matches_jax_and_sequential(stack, m):
    jblock, jstacked, ours = stack
    x = _micro(m, seed=42)
    want = np.asarray(jpipe.gpipe_apply(
        lambda p, h: jblock.apply({"params": p}, h),
        jpipe.shard_stages(jstacked, _jax_pipe_mesh()), jnp.asarray(x), mesh=_jax_pipe_mesh()))
    stacked = stack_layer_params(ours)
    apply_layer = _apply_layer()
    got = gpipe_apply(apply_layer, shard_stages(stacked, _pipe_mesh()), torch.from_numpy(x),
                      mesh=_pipe_mesh())
    seq = sequential_apply(apply_layer, stacked, torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5, atol=1e-5)


def test_gradients_match_jax_and_sequential(stack):
    jblock, jstacked, ours = stack
    x = _micro(4, seed=7)

    def loss_jax(params):
        out = jpipe.gpipe_apply(lambda p, h: jblock.apply({"params": p}, h), params,
                                jnp.asarray(x), mesh=_jax_pipe_mesh())
        return jnp.sum(out ** 2)

    want = _flat(jax.device_get(jax.grad(loss_jax)(
        jpipe.shard_stages(jstacked, _jax_pipe_mesh()))))
    apply_layer = _apply_layer()
    grads = []
    for run in ("pipe", "sequential"):
        stacked = {k: v.clone().requires_grad_(True)
                   for k, v in stack_layer_params(ours).items()}
        xin = torch.from_numpy(x).requires_grad_(True)
        if run == "pipe":  # through the stage split, its hops and the schedule
            out = gpipe_apply(apply_layer, shard_stages(stacked, _pipe_mesh()), xin,
                              mesh=_pipe_mesh())
        else:
            out = sequential_apply(apply_layer, stacked, xin)
        (out ** 2).sum().backward()
        grads.append(({k: v.grad.numpy() for k, v in stacked.items()}, xin.grad.numpy()))
    (pipe, pipe_x), (seq, seq_x) = grads
    assert pipe.keys() == want.keys() == seq.keys()
    for k in want:
        scale = F32_SUM_SCALE * float(np.abs(want[k]).max())
        np.testing.assert_allclose(pipe[k], want[k], rtol=1e-4, atol=1e-4 + scale, err_msg=k)
        np.testing.assert_allclose(pipe[k], seq[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(pipe_x, seq_x, rtol=1e-4, atol=1e-4)
    assert float(np.abs(pipe["mlp.fc1.kernel"]).max()) > 0


def test_stages_hold_their_layers(stack):
    """shard_stages puts layers [2s, 2s + 2) on stage s; gpipe_apply takes
    the (L, ...) stack unsplit too, and refuses a stack the stages do not
    divide."""
    _, _, ours = stack
    stacked = stack_layer_params(ours)
    parts = shard_stages(stacked, _pipe_mesh())
    k = "attn.q_proj.kernel"
    assert stacked[k].shape == (LAYERS, WIDTH, WIDTH) and len(parts[k]) == STAGES
    for s in range(STAGES):
        assert torch.equal(parts[k][s], stacked[k][2 * s: 2 * s + 2])
    x = torch.from_numpy(_micro(3, seed=1))
    apply_layer = _apply_layer()
    assert torch.equal(gpipe_apply(apply_layer, stacked, x, mesh=_pipe_mesh()),
                       gpipe_apply(apply_layer, parts, x, mesh=_pipe_mesh()))
    with pytest.raises(ValueError, match="does not split"):
        shard_stages({k: v[:6] for k, v in stacked.items()}, _pipe_mesh())
