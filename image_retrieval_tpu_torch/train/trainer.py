"""Contrastive CLIP training on one device or over a (data, model) mesh.

Port of ``image_retrieval_tpu/train/trainer.py``: ``clip_contrastive_loss``
(l.34), the tensor-parallel rules ``_param_spec`` / ``param_shardings``
(l.43-66) and ``CLIPTrainer`` (l.69), whose step (l.121-136) is encode both
towers -> unit embeddings -> ``exp(logit_scale)``-scaled f32 logits ->
symmetric InfoNCE -> gradients -> AdamW.

On one device (``device=``, or a one-device mesh) the step runs the model
as it is. Over a mesh, one process drives every shard, as the JAX trainer is
one program over its devices (parallel/mesh.py), and a step is one autograd
graph across the shards' devices:

- the batch splits over ``data``; each data shard encodes its rows on its
  device and its unit embeddings are gathered onto the mesh's first device,
  where the global (B, B) logits and the loss are computed, as GSPMD
  all-gathers the embeddings;
- the q/k/v and fc1 kernels and biases split by columns over ``model``, the
  out_proj and fc2 kernels by rows (``param_shardings``); each part and its
  optimizer state live once, on the part's home device (``NamedSharding``),
  and every other parameter once on the mesh's first device. A shard on
  another device reads a parameter through ``.to()``, which autograd
  differentiates, so the gradients come out already summed over the shards
  and the elementwise AdamW update of each part is the global one;
- on the plain route each model shard of a layer computes its q/k/v and fc1
  columns and its out_proj and fc2 partial products, whose sum is taken on
  the data shard's device before the bias and the residual; the heads split
  with the columns where ``model`` divides them, else the attention runs
  whole on the data shard's device between the split projections;
- a kernel route (the training kernel configuration, the int8 kernels) runs
  whole layers on each data shard: the shard gathers the layer's parts onto
  its device first, the function GSPMD computes around an opaque call.

Under ``ModelConfig(fused_attn_block=True, fused_mlp_block=True,
fused_train_vjp=True)``, the training kernel configuration, every layer's
attention half runs ``attention_block_train`` (its forward keeps what its
hand-written backward reads) and its MLP half ``mlp_block`` (whose backward
recomputes through the plain version); the parameters, the optimizer and the
loss are the same as under the default configuration.

Under ``int8_matmuls`` with ``fused_attn_block`` + ``fused_mlp_block`` the
layers train through the int8 sub-block kernels (``attention_block_int8``,
``mlp_block_int8``), with ``fused_layer_block`` through the whole-layer
``layer_block_int8`` (the sub-blocks past width 768, as ``layer_mode``
routes): the forward quantizes the f32 parameters on every step, the
backward is the dense plain version's (straight-through, as the JAX
package's custom VJPs).

The trainer draws no random numbers: initial weights come from a numpy seed
(``models/weights.py::init_params``) and the layers have no dropout.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from image_retrieval_tpu_torch.config import ModelConfig
from image_retrieval_tpu_torch.device import DeviceLike, require_full_f32, torch_dtype
from image_retrieval_tpu_torch.models.clip import CLIP, PLAIN, Block
from image_retrieval_tpu_torch.ops.flash_attention import fast_layernorm_f32, quick_gelu
from image_retrieval_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    Spec,
    entry_mesh,
    on_device,
    shard_rows,
)

_COLUMN = ("q_proj", "k_proj", "v_proj", "fc1")
_ROW = ("out_proj", "fc2")
# the towers' parameters outside their layers that the head reads
_HEAD = ("post_ln", "final_ln", "proj")


def clip_contrastive_loss(logits: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the (B, B) image->text logit matrix."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))


def unit_rows(e: torch.Tensor) -> torch.Tensor:
    """Embeddings scaled to unit length, as the step normalizes them."""
    return e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-8)


def _param_spec(key: str, tensor) -> Spec:
    """Tensor-parallel sharding rules for CLIP parameters (the JAX rules,
    trainer.py:43-60, on the port's key names). Column-parallel (output dim
    on `model`): attention q/k/v, MLP fc1, kernels and biases. Row-parallel
    (input dim on `model`): attention out_proj, MLP fc2 kernels. Everything
    else replicated."""
    if tensor.ndim == 2 and key.endswith("kernel"):
        if any(s in key for s in _COLUMN):
            return (None, "model")
        if any(s in key for s in _ROW):
            return ("model", None)
    if tensor.ndim == 1 and key.endswith("bias") and any(s in key for s in _COLUMN):
        return ("model",)
    return ()


def param_shardings(state_dict, mesh: Mesh) -> Dict[str, NamedSharding]:
    """Each parameter's placement on `mesh`: key -> NamedSharding."""
    return {k: NamedSharding(mesh, _param_spec(k, v)) for k, v in state_dict.items()}


class _Method(nn.Module):
    """``module.<name>(*args)`` as a module's forward, so that
    torch.func.functional_call runs a method other than forward on tensors
    given for the module's parameters (keys under ``m.``)."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.m, self.name = module, name

    def forward(self, *args):
        return getattr(self.m, self.name)(*args)


class CLIPTrainer:
    """Train step and a simple host loop, on one device or over a mesh.

    `params` is a state dict of models/weights.py (``params_from_jax`` carries
    the JAX package's tree over); without one the weights are
    ``init_params(cfg, seed)``. `optimizer` maps the trainer's parameters (on
    a mesh: every part of every parameter) to a ``torch.optim.Optimizer``;
    the default is AdamW over all of them with optax.adamw's constants (b1
    0.9, b2 0.999, eps 1e-8 outside the root, decoupled weight decay on every
    parameter), the JAX trainer's rule term for term.

    `mesh` is a (data, model) ``parallel.mesh.Mesh``; `device` a one-device
    mesh there; neither, every visible card (``make_mesh()``); both raise.
    Nothing falls back to the CPU: without a card and without
    ``device="cpu"`` the trainer raises."""

    def __init__(self, cfg: Optional[ModelConfig] = None, learning_rate: float = 1e-4,
                 weight_decay: float = 0.01, seed: int = 0, params=None,
                 optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]],
                                              torch.optim.Optimizer]] = None,
                 *, mesh: Optional[Mesh] = None, device: Optional[DeviceLike] = None):
        self.cfg = cfg or ModelConfig()
        fused = self.cfg.fused_attn_block or self.cfg.fused_layer_block
        if self.cfg.int8_matmuls and not fused:
            # unfused QuantDense trains too (straight-through), but quantizes
            # every projection with none of the fused kernels' speed: the
            # trainer sends int8 training through the fused kernels
            raise ValueError(
                "int8_matmuls without fused kernels: use the fused-kernel "
                "STE path (fused_attn_block/fused_layer_block) for int8 "
                "training, or the default config for bf16/f32 training. "
                "(Direct jax.grad over unfused QuantDense does work — "
                "straight-through — but is never the fast configuration.)")
        self.mesh = entry_mesh(device, mesh)
        if set(self.mesh.axis_names) != {"data", "model"}:
            raise ValueError(f"CLIPTrainer needs a (data, model) mesh, got "
                             f"{self.mesh.axis_names}")
        self.device = self.mesh.first
        self._dt = torch_dtype(self.cfg.dtype)
        if params is None:
            from image_retrieval_tpu_torch.models.weights import init_params

            params = init_params(self.cfg, seed=seed)
        params = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()}
        if self.mesh.devices.size == 1:
            self.model = CLIP(self.cfg, dtype=self._dt)
            self.model.load_state_dict(params)
            self.model.to(self.device).train()
            self._parts = None
            leaves = list(self.model.parameters())
        else:
            leaves = self._place(params)
        if optimizer is None:
            self.optimizer = torch.optim.AdamW(
                leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=weight_decay)
        else:
            self.optimizer = optimizer(leaves)

    def _place(self, params) -> List[nn.Parameter]:
        """Lay the parameters out over the mesh (module docstring); returns
        every part, in state-dict order."""
        with torch.device("meta"):  # the layout of the modules, no storage
            self.model = CLIP(self.cfg, dtype=self._dt)
        self.model.train()
        self._names = [k for k, _ in self.model.named_parameters()]
        missing = set(self._names) - params.keys()
        unexpected = params.keys() - set(self._names)
        if missing or unexpected:
            raise KeyError(f"state dict: missing {sorted(missing)[:4]}, unexpected "
                           f"{sorted(unexpected)[:4]}")
        self.shardings = param_shardings(params, self.mesh)
        self._parts = {k: [nn.Parameter(p.detach().clone())
                           for p in self.shardings[k].put(params[k])]
                       for k in self._names}
        grid = self.mesh.devices
        if self.mesh.axis_names[0] != "data":
            grid = grid.T
        self._model_devices = [list(row) for row in grid]  # [data shard][model shard]
        self._tp = self.mesh.shape["model"] > 1
        # each tower's embed and head as a module, and the parameters each reads
        self._calls, self._outer = {}, {}
        for t in ("vision", "text"):
            tower = getattr(self.model, t)
            for m in ("embed", "head"):
                self._calls[t, m] = _Method(tower, m)
                self._outer[t, m] = [k for k, _ in tower.named_parameters()
                                     if not k.startswith("blocks.")
                                     and (k.split(".")[0] in _HEAD) == (m == "head")]
        self._block_keys = [k for k, _ in self.model.vision.blocks[0].named_parameters()]
        leaves, self._leaf_key = [], []
        for i, k in enumerate(self._names):
            leaves += self._parts[k]
            self._leaf_key += [i] * len(self._parts[k])
        return leaves

    # -- the step over a mesh ---------------------------------------------------

    def _full(self, key: str, device: torch.device) -> torch.Tensor:
        """The whole parameter on `device`, gathered from its parts."""
        return self.shardings[key].gather(self._parts[key], device)

    def _call(self, tower: str, method: str, device: torch.device, *args):
        """The tower's embed or head on `device`, on its parameters there."""
        params = {f"m.{k}": self._full(f"{tower}.{k}", device)
                  for k in self._outer[tower, method]}
        return torch.func.functional_call(self._calls[tower, method], params, args)

    def _layer(self, tower: str, layer: int, x: torch.Tensor, mask, shard: int):
        blk = getattr(self.model, tower).blocks[layer]
        prefix = f"{tower}.blocks.{layer}."
        if self._tp and blk.mode == (PLAIN, PLAIN):
            return self._tp_layer(blk, prefix, x, mask, shard)
        dev = x.device  # a kernel route: the whole layer on the data shard
        params = {k: self._full(prefix + k, dev) for k in self._block_keys}
        return torch.func.functional_call(blk, params, (x, self._dt, mask))

    def _tp_layer(self, blk: Block, prefix: str, x: torch.Tensor, mask, shard: int):
        """One plain layer with its projections split over `model`."""
        dt, home = self._dt, x.device
        devs = self._model_devices[shard]
        n = len(devs)
        part = lambda name, j: self._parts[prefix + name][j].to(devs[j])
        whole = lambda name: self._parts[prefix + name][0].to(home)

        def dense(h, name, j):  # models/clip.py Dense on model shard j's columns
            return h.to(dt) @ part(f"{name}.kernel", j).to(dt) + part(f"{name}.bias", j).to(dt)

        def reduce(partials, bias):  # the row-parallel sum, then the bias
            total = partials[0].float()
            for p in partials[1:]:
                total = total + p.float()
            return total.to(dt) + whole(bias).to(dt)

        h = fast_layernorm_f32(x.float(), whole("ln1.scale"), whole("ln1.bias"))
        if blk.heads % n == 0:  # each model shard attends over its own heads
            outs = []
            for j, d in enumerate(devs):
                with on_device(d):
                    hj = h.to(d)
                    q, k, v = (dense(hj, f"attn.{s}", j) for s in ("q_proj", "k_proj", "v_proj"))
                    outs.append(blk.attn.attend(q, k, v, dt, None if mask is None
                                                else mask.to(d), blk.heads // n))
        else:  # heads cut by the columns: the attention runs whole at home
            q, k, v = (torch.cat([dense(h.to(d), f"attn.{s}", j).to(home)
                                  for j, d in enumerate(devs)], -1)
                       for s in ("q_proj", "k_proj", "v_proj"))
            outs = [o.to(d) for o, d in zip(blk.attn.attend(q, k, v, dt, mask).chunk(n, -1),
                                            devs)]
        partials = []
        for j, d in enumerate(devs):
            with on_device(d):
                partials.append((outs[j].to(dt) @ part("attn.out_proj.kernel", j).to(dt))
                                .to(home))
        x = x + reduce(partials, "attn.out_proj.bias")
        h = fast_layernorm_f32(x.float(), whole("ln2.scale"), whole("ln2.bias"))
        partials = []
        for j, d in enumerate(devs):
            with on_device(d):
                g = quick_gelu(dense(h.to(d), "mlp.fc1", j))
                partials.append((g.to(dt) @ part("mlp.fc2.kernel", j).to(dt)).to(home))
        return x + reduce(partials, "mlp.fc2.bias")

    def _tower(self, tower: str, feed: torch.Tensor, shard: int) -> torch.Tensor:
        """Data shard `shard`'s (rows, embed_dim) f32 embeddings of `tower`."""
        dev = feed.device
        x, mask = self._call(tower, "embed", dev, feed)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in range(len(getattr(self.model, tower).blocks)):
            if remat:  # ModelConfig.remat: keep each layer's input only
                x = checkpoint(self._layer, tower, layer, x, mask, shard,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = self._layer(tower, layer, x, mask, shard)
        return self._call(tower, "head", dev, x, *((feed,) if tower == "text" else ()))

    def _mesh_loss(self, pixels: List[torch.Tensor], tokens: List[torch.Tensor]):
        first = self.device
        imgs, txts = [], []
        for shard, (px, tok) in enumerate(zip(pixels, tokens)):
            dev = px.device
            require_full_f32(dev)  # the f32 logits and products
            with on_device(dev):
                img = unit_rows(self._tower("vision", px, shard))
                txt = unit_rows(self._tower("text", tok, shard))
            imgs.append(img.to(first))
            txts.append(txt.to(first))
        img, txt = torch.cat(imgs), torch.cat(txts)
        logits = torch.exp(self._full("logit_scale", first)) * (img @ txt.t())
        return clip_contrastive_loss(logits)

    # -- the public step --------------------------------------------------------

    @property
    def params(self):
        """The model's state dict; ``models/weights.py::params_to_jax`` turns
        it into the JAX tree. On one device the live tensors; over a mesh
        each parameter gathered whole onto the mesh's first device (as
        jax.device_get of the sharded arrays)."""
        if self._parts is None:
            return self.model.state_dict()
        return {k: self._full(k, self.device).detach() for k in self._names}

    def loss(self, pixels, tokens) -> torch.Tensor:
        """The step's loss: (B, S, S, 3) normalized pixels and (B, T) token
        ids, as device tensors (one device) or as what ``_to_device`` gives
        (a mesh: lists of data shards; whole batches are split here)."""
        if self._parts is not None:
            if not isinstance(pixels, list):
                pixels, tokens = self._to_device(pixels, tokens)
            return self._mesh_loss(pixels, tokens)
        require_full_f32(self.device)  # the f32 logits
        img = unit_rows(self.model.encode_image(pixels))
        txt = unit_rows(self.model.encode_text(tokens))
        logits = torch.exp(self.model.logit_scale) * (img @ txt.t())
        return clip_contrastive_loss(logits)

    def _to_device(self, pixels, tokens):
        """A batch as numpy arrays (train/data.py) or tensors -> f32 pixels
        and int64 token ids on the trainer's device; over a mesh, lists of
        the data shards' rows, each on its shard's device (the batch must
        split evenly over ``data``)."""
        as_tensor = lambda a: a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        px, tok = as_tensor(pixels), as_tensor(tokens)
        if self._parts is None:
            return px.to(self.device, torch.float32), tok.to(self.device, torch.int64)
        return ([p.to(torch.float32) for p in shard_rows(px, self.mesh, "data")],
                [t.to(torch.int64) for t in shard_rows(tok, self.mesh, "data")])

    def train_step_async(self, pixels, tokens) -> torch.Tensor:
        """One optimizer step; returns the loss as a tensor on the trainer's
        (first) device with no host sync, so that the host runs ahead of the
        card and back-to-back steps leave it no gap."""
        px, tok = self._to_device(pixels, tokens)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(px, tok)
        loss.backward()
        self.optimizer.step()
        for m in self.model.modules():
            if isinstance(m, Block):
                m._drop_caches()  # weights cast for passes without gradients
        return loss.detach()

    def train_step(self, pixels, tokens) -> float:
        """One optimizer step on a (global) batch; fetches the loss, which
        waits for the device: prefer fit() or train_step_async() for
        throughput."""
        return float(self.train_step_async(pixels, tokens))

    def fit(self, batches, steps: Optional[int] = None,
            max_in_flight: int = 8) -> List[float]:
        """Training loop over (pixels, tokens) batches: steps are enqueued
        without waiting, the host waits for the device every `max_in_flight`
        steps (each step in flight holds its input batch in device memory),
        and the losses come back in one transfer at the end."""
        losses = []
        for i, (pixels, tokens) in enumerate(batches):
            if steps is not None and i >= steps:
                break
            losses.append(self.train_step_async(pixels, tokens))
            if len(losses) % max_in_flight == 0:
                losses[-1].item()  # bound the steps in flight
        if not losses:
            return []
        return [float(v) for v in torch.stack(losses).cpu()]

    # -- checkpoint / resume ---------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """The model's and the optimizer's state dicts in one file. Over a
        mesh each is gathered whole, in the one-device layout (the optimizer
        state keyed by the parameter's index in the state dict), so that a
        checkpoint restores on any mesh or device."""
        if self._parts is None:
            torch.save({"params": self.model.state_dict(),
                        "opt_state": self.optimizer.state_dict()}, path)
            return
        sd = self.optimizer.state_dict()
        state: Dict[int, dict] = {}
        for leaf, st in sd["state"].items():
            key = self._leaf_key[leaf]
            if key in state:
                continue
            name = self._names[key]
            parts = [sd["state"][i] for i, k in enumerate(self._leaf_key) if k == key]
            state[key] = {f: (self.shardings[name].gather([p[f] for p in parts], self.device)
                              if isinstance(v, torch.Tensor) and v.dim() else v)
                          for f, v in st.items()}
        groups = [dict(g, params=sorted({self._leaf_key[i] for i in g["params"]}))
                  for g in sd["param_groups"]]
        torch.save({"params": self.params,
                    "opt_state": {"state": state, "param_groups": groups}}, path)

    def restore_checkpoint(self, path: str) -> None:
        if self._parts is None:
            restored = torch.load(path, map_location=self.device, weights_only=True)
            self.model.load_state_dict(restored["params"])
            self.optimizer.load_state_dict(restored["opt_state"])
            return
        restored = torch.load(path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for k in self._names:
                for leaf, p in zip(self._parts[k], self.shardings[k].put(restored["params"][k])):
                    leaf.copy_(p)
        opt = restored["opt_state"]
        leaves_of = {}
        for i, k in enumerate(self._leaf_key):
            leaves_of.setdefault(k, []).append(i)
        state = {}
        for key, st in opt["state"].items():
            sharding = self.shardings[self._names[int(key)]]
            # a scalar (AdamW's step) a part each: the optimizer counts in place
            split = {f: (sharding.put(v) if isinstance(v, torch.Tensor) and v.dim()
                         else [v.clone() if isinstance(v, torch.Tensor) else v
                               for _ in range(sharding.parts)])
                     for f, v in st.items()}
            for j, leaf in enumerate(leaves_of[int(key)]):
                state[leaf] = {f: parts[j] for f, parts in split.items()}
        groups = [dict(g, params=[i for k in g["params"] for i in leaves_of[int(k)]])
                  for g in opt["param_groups"]]
        self.optimizer.load_state_dict({"state": state, "param_groups": groups})
