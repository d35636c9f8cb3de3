"""Pipelined CLIP training: data x pipeline parallelism — port of
``image_retrieval_tpu/train/pipelined.py``.

A trainer over a (data, pipe) mesh:

- the transformer trunks (the homogeneous Block stacks of both towers) are
  stage-sharded over ``pipe`` and run with the GPipe schedule
  (parallel/pipeline.py::gpipe_apply: microbatches, activations hopping
  stage to stage, autograd through the schedule);
- the embeddings, heads and logit_scale live once, on the mesh's first
  device, and each data shard reads them there;
- the batch splits over ``data``; each data shard runs its rows through its
  own row of stage devices, and the unit embeddings are gathered onto the
  mesh's first device for the global contrastive matrix;
- the optimizer updates each part where it lives (AdamW is elementwise:
  the local update is the global one).

One process drives every device (parallel/mesh.py) and the step is one
autograd graph, so its gradients are the true gradient by construction: the
JAX trainer, whose every device computes the same loss under a
``shard_map``, divides its psums by the mesh size for that
(pipelined.py:253-265 there).

The trunks are plain ``Block``s, whatever the configuration's kernel flags,
as the JAX trainer's ``Block(width, heads, dtype)`` are; they recompute in
the backward pass under ``ModelConfig.remat``. The text trunk's causal mask
follows the batch's own token length.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from image_retrieval_tpu_torch.config import ModelConfig
from image_retrieval_tpu_torch.device import require_full_f32, torch_dtype
from image_retrieval_tpu_torch.models.clip import (
    PLAIN,
    Block,
    LayerNorm,
    PatchEmbed,
    _param,
    causal_mask,
    text_pool,
    text_tokens,
    vision_pool,
    vision_tokens,
)
from image_retrieval_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    on_device,
    row_spec,
    shard_rows,
)
from image_retrieval_tpu_torch.parallel.pipeline import gpipe_apply, stack_layer_params
from image_retrieval_tpu_torch.train.trainer import clip_contrastive_loss, unit_rows


class VisionEmbed(nn.Module):
    """Patch conv + [CLS] + positions + pre-LN (parameter names those of
    CLIPVisionTower, so a standard state dict slices straight in)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = PatchEmbed(cfg.vision_width, cfg.patch_size)
        self.class_embedding = _param(cfg.vision_width)
        self.position_embedding = _param(n + 1, cfg.vision_width)
        self.pre_ln = LayerNorm(cfg.vision_width)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return vision_tokens(self, pixels, self.dtype)


class VisionHead(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.post_ln = LayerNorm(cfg.vision_width)
        self.proj = _param(cfg.vision_width, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return vision_pool(self, x, self.dtype)


class TextEmbed(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = _param(cfg.vocab_size, cfg.text_width)
        self.position_embedding = _param(cfg.context_length, cfg.text_width)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return text_tokens(self, token_ids, self.dtype)


class TextHead(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.final_ln = LayerNorm(cfg.text_width)
        self.proj = _param(cfg.text_width, cfg.embed_dim)

    def forward(self, x: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
        return text_pool(self, x, token_ids, self.dtype)


_V_EMBED_KEYS = ("patch_embed", "class_embedding", "position_embedding", "pre_ln")
_V_HEAD_KEYS = ("post_ln", "proj")
_T_EMBED_KEYS = ("token_embedding", "position_embedding")
_T_HEAD_KEYS = ("final_ln", "proj")
_STACKED = ("vb", "tb")


def _under(state_dict, prefix: str, names) -> Dict[str, torch.Tensor]:
    """The entries `prefix`.<name>[.…] for each of `names`, without the prefix."""
    out = {}
    for k, v in state_dict.items():
        rest = k[len(prefix) + 1:]
        if k.startswith(prefix + ".") and rest.split(".")[0] in names:
            out[rest] = v
    return out


def _layer_dicts(state_dict, tower: str, layers: int):
    return [_under(state_dict, f"{tower}.blocks.{i}", ("ln1", "attn", "ln2", "mlp"))
            for i in range(layers)]


def split_clip_params(params, cfg: ModelConfig):
    """A standard state dict (models/weights.py) -> the pipelined layout
    {ve, vb (stacked), vh, te, tb (stacked), th, logit_scale}: each part a
    dict of the tower's parameter names, vb and tb of (layers, ...) tensors."""
    sd = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()}
    return {
        "ve": _under(sd, "vision", _V_EMBED_KEYS),
        "vb": stack_layer_params(_layer_dicts(sd, "vision", cfg.vision_layers)),
        "vh": _under(sd, "vision", _V_HEAD_KEYS),
        "te": _under(sd, "text", _T_EMBED_KEYS),
        "tb": stack_layer_params(_layer_dicts(sd, "text", cfg.text_layers)),
        "th": _under(sd, "text", _T_HEAD_KEYS),
        "logit_scale": sd["logit_scale"],
    }


class PipelinedCLIPTrainer:
    """dp x pp contrastive training; see the module docstring. `mesh` is a
    ``parallel.mesh.Mesh`` with ``data`` and ``pipe`` axes, whose pipe axis
    divides both towers' depths; a batch must split over data shards x
    `num_micro` microbatches. `optimizer` maps every part of every parameter
    to a ``torch.optim.Optimizer``; the default is CLIPTrainer's AdamW."""

    def __init__(self, cfg: Optional[ModelConfig] = None, mesh: Optional[Mesh] = None,
                 num_micro: int = 2, learning_rate: float = 1e-4, weight_decay: float = 0.01,
                 seed: int = 0, params=None,
                 optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]],
                                              torch.optim.Optimizer]] = None):
        self.cfg = cfg or ModelConfig()
        if self.cfg.int8_matmuls and not (self.cfg.fused_attn_block
                                          or self.cfg.fused_layer_block):
            raise ValueError("int8_matmuls without fused kernels is inference-only "
                             "(non-differentiable QuantDense) - see CLIPTrainer")
        if mesh is None or set(mesh.axis_names) != {"data", "pipe"}:
            raise ValueError("PipelinedCLIPTrainer needs a mesh with data and pipe axes")
        self.mesh = mesh
        stages = mesh.shape["pipe"]
        if self.cfg.vision_layers % stages:
            raise ValueError("vision layers % stages")
        if self.cfg.text_layers % stages:
            raise ValueError("text layers % stages")
        self.num_micro = num_micro
        self.device = mesh.first
        c, dt = self.cfg, torch_dtype(self.cfg.dtype)
        self.dtype = dt
        if params is None:
            from image_retrieval_tpu_torch.models.weights import init_params

            params = init_params(c, seed=seed)
        split = split_clip_params(params, c)
        # every part of every parameter, on its home (stacked layers split
        # over pipe, the rest on the mesh's first device)
        self._parts: Dict[str, Dict[str, list]] = {}
        self.shardings: Dict[str, Dict[str, NamedSharding]] = {}
        for group, tree in split.items():
            tree = tree if isinstance(tree, dict) else {"": tree}
            self.shardings[group] = {
                k: NamedSharding(mesh, row_spec(v.ndim, "pipe") if group in _STACKED else ())
                for k, v in tree.items()}
            self._parts[group] = {k: [nn.Parameter(p.detach().clone())
                                      for p in self.shardings[group][k].put(v)]
                                  for k, v in tree.items()}
        leaves = [p for tree in self._parts.values() for ps in tree.values() for p in ps]
        if optimizer is None:
            self.optimizer = torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                                               eps=1e-8, weight_decay=weight_decay)
        else:
            self.optimizer = optimizer(leaves)
        with torch.device("meta"):  # the modules' layout; the tensors are the parts
            self._modules = {"ve": VisionEmbed(c, dt), "vh": VisionHead(c, dt),
                             "te": TextEmbed(c, dt), "th": TextHead(c, dt),
                             "vb": Block(c.vision_width, c.vision_heads, False, (PLAIN, PLAIN)),
                             "tb": Block(c.text_width, c.text_heads, True, (PLAIN, PLAIN))}
        grid = mesh.devices if mesh.axis_names[0] == "data" else mesh.devices.T
        # each data shard's row of stage devices, a one-axis pipe mesh
        self._rows = [Mesh(list(row), ("pipe",)) for row in grid]

    def _whole(self, group: str, device: torch.device) -> Dict[str, torch.Tensor]:
        return {k: self.shardings[group][k].gather(ps, device)
                for k, ps in self._parts[group].items()}

    def _apply(self, group: str, device: torch.device, *args):
        return torch.func.functional_call(self._modules[group], self._whole(group, device),
                                          args)

    def _trunk(self, group: str, x: torch.Tensor, row: Mesh, mask_len: Optional[int]):
        """The group's layers over the microbatches (M, mb, T, W), pipelined
        over the data shard's row of stage devices."""
        block, dt = self._modules[group], self.dtype
        remat = self.cfg.remat and torch.is_grad_enabled()

        def layer(params, h):
            mask = None if mask_len is None else causal_mask(mask_len, h.device)
            return torch.func.functional_call(block, params, (h, dt, mask))

        def apply_layer(params, h):
            if remat:
                return checkpoint(layer, params, h, use_reentrant=False,
                                  preserve_rng_state=False)
            return layer(params, h)

        return gpipe_apply(apply_layer, self._parts[group], x, mesh=row)

    def loss(self, pixels, tokens) -> torch.Tensor:
        """The step's loss on a whole batch (numpy arrays or tensors)."""
        as_tensor = lambda a: a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        px_parts = shard_rows(as_tensor(pixels), self.mesh, "data")
        tok_parts = shard_rows(as_tensor(tokens), self.mesh, "data")
        first, m = self.device, self.num_micro
        imgs, txts = [], []
        for px, tok, row in zip(px_parts, tok_parts, self._rows):
            dev = px.device
            require_full_f32(dev)  # the f32 logits and products
            b = px.shape[0]
            if b % m:
                raise ValueError(f"{b} rows a data shard do not split into {m} microbatches")
            px, tok = px.to(torch.float32), tok.to(torch.int64)
            with on_device(dev):
                x = self._apply("ve", dev, px)
                x = self._trunk("vb", x.reshape(m, b // m, *x.shape[1:]), row, None)
                img = self._apply("vh", dev, x.reshape(b, *x.shape[2:]))
                x = self._apply("te", dev, tok)
                x = self._trunk("tb", x.reshape(m, b // m, *x.shape[1:]), row, tok.shape[1])
                txt = self._apply("th", dev, x.reshape(b, *x.shape[2:]), tok)
            imgs.append(unit_rows(img).to(first))
            txts.append(unit_rows(txt).to(first))
        img, txt = torch.cat(imgs), torch.cat(txts)
        scale = self._parts["logit_scale"][""][0].to(first)
        return clip_contrastive_loss(torch.exp(scale) * (img @ txt.t()))

    @property
    def params(self):
        """The split layout (split_clip_params), each parameter gathered
        whole onto the mesh's first device."""
        out = {g: {k: v.detach() for k, v in self._whole(g, self.device).items()}
               for g in self._parts if g != "logit_scale"}
        out["logit_scale"] = self._whole("logit_scale", self.device)[""].detach()
        return out

    def train_step_async(self, pixels, tokens) -> torch.Tensor:
        """One step, the loss returned as a tensor on the mesh's first device
        (no host sync), so that consecutive steps queue back to back — see
        CLIPTrainer.train_step_async."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(pixels, tokens)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_step(self, pixels, tokens) -> float:
        """pixels (B, H, W, 3), tokens (B, T); B must split over data shards
        x num_micro. Synchronous; prefer train_step_async for throughput."""
        return float(self.train_step_async(pixels, tokens))
