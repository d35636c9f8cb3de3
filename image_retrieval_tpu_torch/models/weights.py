"""Weights for the port's CLIP: carried across from the JAX package, mapped
from a Hugging Face checkpoint, or initialized from a numpy seed; and the
model configuration of such a checkpoint (``model_config_from_hf``).

Every function but ``params_to_jax`` and ``model_config_from_hf`` returns a
state dict (name -> f32
tensor) for ``models.clip.CLIP.load_state_dict``. Names follow the Flax
tree, so the JAX->port mapping is a rename of the tower-block keys only;
``params_to_jax`` is its inverse.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

from image_retrieval_tpu_torch.config import ModelConfig

StateDict = Dict[str, torch.Tensor]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def params_from_jax(flax_params, cfg: ModelConfig) -> StateDict:
    """The JAX package's CLIP parameter tree (``{"params": {...}}`` as
    ``init_params`` or ``load_hf_clip_params`` return it, leaves as numpy or
    any array numpy can read) -> the port's state dict. `cfg` must describe
    the same model; its tower depths are checked."""
    tree = flax_params.get("params", flax_params)
    flat = _flatten(tree)
    sd = {}
    for name, v in flat.items():
        name = re.sub(r"\.block_(\d+)\.", r".blocks.\1.", name)
        name = name.replace("text.token_embedding.embedding", "text.token_embedding")
        sd[name] = torch.from_numpy(np.array(v, dtype=np.float32))
    for tower, layers in (("vision", cfg.vision_layers), ("text", cfg.text_layers)):
        have = {int(m.group(1)) for k in sd
                if (m := re.match(rf"{tower}\.blocks\.(\d+)\.", k))}
        if have != set(range(layers)):
            raise ValueError(f"{tower} tower has blocks {sorted(have)}, "
                             f"config says {layers}")
    return sd


def params_to_jax(state_dict: Mapping, cfg: ModelConfig) -> Dict:
    """The inverse of params_from_jax: a state dict of the port's CLIP ->
    the JAX package's parameter tree ``{"params": {...}}`` with f32 numpy
    leaves, so that a model trained here loads there. `cfg` must describe
    the same model; its tower depths are checked."""
    for tower, layers in (("vision", cfg.vision_layers), ("text", cfg.text_layers)):
        have = {int(m.group(1)) for k in state_dict
                if (m := re.match(rf"{tower}\.blocks\.(\d+)\.", k))}
        if have != set(range(layers)):
            raise ValueError(f"{tower} tower has blocks {sorted(have)}, "
                             f"config says {layers}")
    tree: Dict = {}
    for name, v in state_dict.items():
        name = re.sub(r"\.blocks\.(\d+)\.", r".block_\1.", name)
        if name == "text.token_embedding":
            name = "text.token_embedding.embedding"
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        node[leaf] = np.array(v, dtype=np.float32)
    return {"params": tree}


def _dense(sd, prefix):
    return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _block(sd, prefix):
    return {
        "ln1": _ln(sd, f"{prefix}.layer_norm1"),
        "ln2": _ln(sd, f"{prefix}.layer_norm2"),
        "attn": {nm: _dense(sd, f"{prefix}.self_attn.{nm}")
                 for nm in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "mlp": {"fc1": _dense(sd, f"{prefix}.mlp.fc1"),
                "fc2": _dense(sd, f"{prefix}.mlp.fc2")},
    }


def params_from_hf_state_dict(sd: Mapping, cfg: ModelConfig) -> StateDict:
    """An HF ``CLIPModel`` state dict (numpy or torch values) -> the port's
    state dict; the same mapping as the JAX package's
    ``params_from_state_dict`` (models/weights.py:107-149)."""
    sd = {k.removeprefix("clip."): (v.detach().float().cpu().numpy()
                                   if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in sd.items()}
    vision = {
        # HF conv weight (out, in, kh, kw) -> (kh, kw, in, out)
        "patch_embed": {"kernel": np.transpose(
            sd["vision_model.embeddings.patch_embedding.weight"], (2, 3, 1, 0))},
        "class_embedding": sd["vision_model.embeddings.class_embedding"],
        "position_embedding": sd["vision_model.embeddings.position_embedding.weight"],
        "pre_ln": _ln(sd, "vision_model.pre_layrnorm"),
        "post_ln": _ln(sd, "vision_model.post_layernorm"),
        "proj": sd["visual_projection.weight"].T,
    }
    for i in range(cfg.vision_layers):
        vision[f"block_{i}"] = _block(sd, f"vision_model.encoder.layers.{i}")
    text = {
        "token_embedding": {"embedding": sd["text_model.embeddings.token_embedding.weight"]},
        "position_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "final_ln": _ln(sd, "text_model.final_layer_norm"),
        "proj": sd["text_projection.weight"].T,
    }
    for i in range(cfg.text_layers):
        text[f"block_{i}"] = _block(sd, f"text_model.encoder.layers.{i}")
    tree = {"vision": vision, "text": text, "logit_scale": sd["logit_scale"]}
    return params_from_jax({"params": tree}, cfg)


def model_config_from_hf(path: str) -> ModelConfig:
    """The ModelConfig of an HF checkpoint directory, from its config.json
    (the CLIPConfig layout: text_config, vision_config, projection_dim), as
    the JAX package's model_config_from_hf (models/weights.py:74-99) reads
    it. Missing keys fall back to the HF CLIPText/VisionConfig defaults,
    which are openai/clip-vit-base-patch32's; the compute dtype is f32.
    Plain json: transformers is not needed."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        c = json.load(f)
    t = c.get("text_config", {})
    v = c.get("vision_config", {})
    return ModelConfig(
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 32),
        vision_width=v.get("hidden_size", 768),
        vision_layers=v.get("num_hidden_layers", 12),
        vision_heads=v.get("num_attention_heads", 12),
        text_width=t.get("hidden_size", 512),
        text_layers=t.get("num_hidden_layers", 12),
        text_heads=t.get("num_attention_heads", 8),
        vocab_size=t.get("vocab_size", 49408),
        context_length=t.get("max_position_embeddings", 77),
        embed_dim=c.get("projection_dim", 512),
        dtype="float32",
    )


def load_hf_clip_params(path: str, cfg: ModelConfig) -> StateDict:
    """State dict from an HF checkpoint directory (model.safetensors or
    pytorch_model.bin)."""
    safep = os.path.join(path, "model.safetensors")
    binp = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(safep):
        from safetensors.torch import load_file

        sd = load_file(safep)
    elif os.path.exists(binp):
        sd = torch.load(binp, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no checkpoint found under {path}")
    return params_from_hf_state_dict(sd, cfg)


def init_params(cfg: ModelConfig, seed: int = 0) -> StateDict:
    """Seeded random weights at CLIP-like scales (numpy only: needs neither
    jax nor transformers). Scales follow HF CLIP's initializer: q/k/v and
    fc2 ~ W^-0.5 (2L)^-0.5, out-proj ~ W^-0.5, fc1 ~ (2W)^-0.5, embeddings
    0.02 (positions 0.01 for text, as the Flax init), projections W^-0.5;
    small random biases and LayerNorm parameters near (1, 0)."""
    rng = np.random.default_rng(seed)
    nrm = lambda std, *shape: (rng.standard_normal(shape) * std).astype(np.float32)

    def ln(w):
        return {"scale": 1.0 + nrm(0.02, w), "bias": nrm(0.02, w)}

    def block(w, layers):
        in_std = w ** -0.5 * (2 * layers) ** -0.5
        dense = lambda i, o, std: {"kernel": nrm(std, i, o), "bias": nrm(0.02, o)}
        return {
            "ln1": ln(w), "ln2": ln(w),
            "attn": {"q_proj": dense(w, w, in_std), "k_proj": dense(w, w, in_std),
                     "v_proj": dense(w, w, in_std), "out_proj": dense(w, w, w ** -0.5)},
            "mlp": {"fc1": dense(w, 4 * w, (2 * w) ** -0.5),
                    "fc2": dense(4 * w, w, in_std)},
        }

    vw, tw, p = cfg.vision_width, cfg.text_width, cfg.patch_size
    n = (cfg.image_size // p) ** 2
    vision = {
        "patch_embed": {"kernel": nrm(1.0 / math.sqrt(p * p * 3), p, p, 3, vw)},
        "class_embedding": nrm(0.02, vw),
        "position_embedding": nrm(0.02, n + 1, vw),
        "pre_ln": ln(vw), "post_ln": ln(vw),
        "proj": nrm(vw ** -0.5, vw, cfg.embed_dim),
    }
    for i in range(cfg.vision_layers):
        vision[f"block_{i}"] = block(vw, cfg.vision_layers)
    text = {
        "token_embedding": {"embedding": nrm(0.02, cfg.vocab_size, tw)},
        "position_embedding": nrm(0.01, cfg.context_length, tw),
        "final_ln": ln(tw),
        "proj": nrm(tw ** -0.5, tw, cfg.embed_dim),
    }
    for i in range(cfg.text_layers):
        text[f"block_{i}"] = block(tw, cfg.text_layers)
    tree = {"vision": vision, "text": text,
            "logit_scale": np.array(2.6592, np.float32)}
    return params_from_jax({"params": tree}, cfg)
