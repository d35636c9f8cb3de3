"""Contrastive CLIP training on one device.

Port of ``image_retrieval_tpu/train/trainer.py``: ``clip_contrastive_loss``
(l.34) and ``CLIPTrainer`` (l.69), whose step (l.121-136) is encode both
towers -> unit embeddings -> ``exp(logit_scale)``-scaled f32 logits ->
symmetric InfoNCE -> gradients -> AdamW. The JAX trainer lays that step over
a (data, model) device mesh; this one runs it on one explicit device, and the
sharded forms (``_param_spec``, ``param_shardings``, the pipelined trainer)
are not ported yet (ROADMAP.md).

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

from typing import Callable, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from image_retrieval_tpu_torch.config import ModelConfig
from image_retrieval_tpu_torch.device import (
    DeviceLike,
    require_full_f32,
    resolve_device,
    torch_dtype,
)
from image_retrieval_tpu_torch.models.clip import CLIP, Block


def clip_contrastive_loss(logits: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the (B, B) image->text logit matrix."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))


class CLIPTrainer:
    """One-device train step and a simple host loop.

    `params` is a state dict of models/weights.py (``params_from_jax`` carries
    the JAX package's tree over); without one the weights are
    ``init_params(cfg, seed)``. `optimizer` maps the model's parameters to a
    ``torch.optim.Optimizer``; the default is AdamW over all of them with
    optax.adamw's constants (b1 0.9, b2 0.999, eps 1e-8 outside the root,
    decoupled weight decay on every parameter), the JAX trainer's rule term
    for term. `device` is the card unless the caller names the CPU."""

    def __init__(self, cfg: Optional[ModelConfig] = None, learning_rate: float = 1e-4,
                 weight_decay: float = 0.01, seed: int = 0, params=None,
                 optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]],
                                              torch.optim.Optimizer]] = None,
                 *, device: DeviceLike = "cuda"):
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
        self.device = resolve_device(device)
        self.model = CLIP(self.cfg, dtype=torch_dtype(self.cfg.dtype))
        if params is None:
            from image_retrieval_tpu_torch.models.weights import init_params

            params = init_params(self.cfg, seed=seed)
        self.model.load_state_dict(
            {k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()})
        self.model.to(self.device).train()
        if optimizer is None:
            self.optimizer = torch.optim.AdamW(
                self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=weight_decay)
        else:
            self.optimizer = optimizer(self.model.parameters())

    @property
    def params(self):
        """The model's state dict (live tensors on the trainer's device);
        ``models/weights.py::params_to_jax`` turns it into the JAX tree."""
        return self.model.state_dict()

    def loss(self, pixels: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The step's loss on device tensors: (B, S, S, 3) normalized pixels
        and (B, T) token ids."""
        require_full_f32(self.device)  # the f32 logits
        img = self.model.encode_image(pixels)
        txt = self.model.encode_text(tokens)
        img = img / (torch.linalg.norm(img, dim=-1, keepdim=True) + 1e-8)
        txt = txt / (torch.linalg.norm(txt, dim=-1, keepdim=True) + 1e-8)
        logits = torch.exp(self.model.logit_scale) * (img @ txt.t())
        return clip_contrastive_loss(logits)

    def _to_device(self, pixels, tokens):
        """A batch as numpy arrays (train/data.py) or tensors -> f32 pixels
        and int64 token ids on the trainer's device."""
        as_tensor = lambda a: a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return (as_tensor(pixels).to(self.device, torch.float32),
                as_tensor(tokens).to(self.device, torch.int64))

    def train_step_async(self, pixels, tokens) -> torch.Tensor:
        """One optimizer step; returns the loss as a tensor on the trainer's
        device with no host sync, so that the host runs ahead of the card
        and back-to-back steps leave it no gap."""
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
        """One optimizer step on a batch; fetches the loss, which waits for
        the device: prefer fit() or train_step_async() for throughput."""
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
        """The model's and the optimizer's state dicts in one file."""
        torch.save({"params": self.model.state_dict(),
                    "opt_state": self.optimizer.state_dict()}, path)

    def restore_checkpoint(self, path: str) -> None:
        restored = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(restored["params"])
        self.optimizer.load_state_dict(restored["opt_state"])
