"""GPipe pipeline parallelism over homogeneous transformer layers — port of
``image_retrieval_tpu/parallel/pipeline.py``.

The CLIP towers are stacks of identical layers (models/clip.py), which makes
them pipeline-able the classic way: stage s of a ``pipe`` mesh axis holds
layers [s*L/S, (s+1)*L/S) on its device; M microbatches flow through the
stages over M + S - 1 ticks, each activation hopping to the next stage's
device by ``.to()``. The JAX package runs the schedule per device inside a
``shard_map`` with ``ppermute`` hops; the port is one process driving every
stage (parallel/mesh.py), so the schedule is one loop over ticks and stages
whose launches queue on each stage's device and, on separate cards, overlap.
Autograd differentiates through the hops (the backward of ``.to()`` carries
the gradient back to the stage that sent the activation), so the same code
serves training.

Layers are state dicts of one ``models.clip.Block`` (``stack_layer_params``
stacks them into (L, ...) tensors); ``apply_layer(layer_params, x)`` is
typically ``torch.func.functional_call`` of one Block on them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Union

import torch

from image_retrieval_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    on_device,
    row_spec,
    shard_devices,
)

Stacked = Dict[str, torch.Tensor]  # name -> (L, ...) tensor
Stages = Dict[str, List[torch.Tensor]]  # name -> one (L/S, ...) part a stage
ApplyLayer = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


def stack_layer_params(layer_params_list: Sequence[Mapping[str, torch.Tensor]]) -> Stacked:
    """[params of layer 0, ...] -> one dict with a leading (L, ...) axis."""
    keys = list(layer_params_list[0])
    return {k: torch.stack([torch.as_tensor(p[k]) for p in layer_params_list]) for k in keys}


def shard_stages(stacked: Stacked, mesh: Mesh, axis: str = "pipe") -> Stages:
    """The stacked layers with their layer axis split over `axis`: stage s's
    L/S layers on its device (the first device of every other mesh axis).
    Differentiable: a gradient on a stage's part reaches `stacked`."""
    return {k: NamedSharding(mesh, row_spec(v.ndim, axis)).put(v) for k, v in stacked.items()}


def _layers(params: Stacked, i: int, device: torch.device):
    """Layer i of a stage's part (or of the whole stack), on `device`."""
    return {k: v[i].to(device) for k, v in params.items()}


def gpipe_apply(apply_layer: ApplyLayer, stacked_params: Union[Stacked, Stages],
                microbatches: torch.Tensor, *, mesh: Mesh, axis: str = "pipe") -> torch.Tensor:
    """Run a stack of L layers over M microbatches, pipelined over the S
    stages of `axis` (the schedule of the JAX ``gpipe_local``).

    Args:
        apply_layer: (one layer's params, x) -> x, the homogeneous layer.
        stacked_params: (L, ...) tensors (split here, L % S == 0), or
            ``shard_stages``' parts. A part is read on its stage's device of
            this mesh through ``.to()``: a mesh whose stage devices differ
            from the parts' homes (a data shard's row of a (data, pipe)
            mesh) reads them there.
        microbatches: (M, mb, ...) inputs.

    At tick t (of M + S - 1) stage s runs microbatch t - s through its
    layers, on the activation stage s - 1 made at tick t - 1; the last stage
    banks microbatch t - (S - 1). Returns the (M, mb, ...) outputs on the
    microbatches' device: the JAX function psum-replicates them over the
    stages, where one controller needs them once."""
    devices = shard_devices(mesh, axis)
    n_stages = len(devices)
    if all(isinstance(v, torch.Tensor) for v in stacked_params.values()):
        stacked_params = shard_stages(stacked_params, mesh, axis)
    if any(len(v) != n_stages for v in stacked_params.values()):
        raise ValueError(f"stage parts {[len(v) for v in stacked_params.values()]} for "
                         f"{n_stages} {axis!r} stages")
    stages = [{k: v[s] for k, v in stacked_params.items()} for s in range(n_stages)]
    per_stage = next(iter(stages[0].values())).shape[0]
    n_micro = microbatches.shape[0]
    outputs: List[torch.Tensor] = [None] * n_micro  # type: ignore[list-item]
    sent: List[torch.Tensor] = [None] * n_stages  # type: ignore[list-item]
    for tick in range(n_micro + n_stages - 1):
        made: List[torch.Tensor] = [None] * n_stages  # type: ignore[list-item]
        for s, dev in enumerate(devices):
            m = tick - s
            if not 0 <= m < n_micro:
                continue  # the bubble: nothing for this stage yet, or any more
            with on_device(dev):
                h = microbatches[m].to(dev) if s == 0 else sent[s - 1].to(dev)
                for i in range(per_stage):
                    h = apply_layer(_layers(stages[s], i, dev), h)
            made[s] = h
            if s == n_stages - 1:
                outputs[m] = h.to(microbatches.device)
        sent = made
    return torch.stack(outputs)


def sequential_apply(apply_layer: ApplyLayer, stacked_params: Stacked,
                     microbatches: torch.Tensor) -> torch.Tensor:
    """Reference execution: all layers, every microbatch, no pipeline."""
    n_layers = next(iter(stacked_params.values())).shape[0]
    outs = []
    for x in microbatches:
        for i in range(n_layers):
            x = apply_layer(_layers(stacked_params, i, x.device), x)
        outs.append(x)
    return torch.stack(outs)
