"""Everything a run feeds to the program and to the reference, made from the
run's seed: the model weights and the gallery rows on the device, the pixel
pool, and the query texts. The same seed gives the same inputs; each kind of
input draws from a stream of its own (`derive`).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def derive(seed: int, what: str) -> int:
    """A 63-bit seed for the stream `what` of the run seeded `seed` (any whole
    number, negative or past 64 bits included)."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, what))


# -- weights -----------------------------------------------------------------


def weight_specs(model: dict) -> list:
    """(name, shape, std, mean) of every parameter of the two towers, under
    the state-dict names the program loads, at CLIP-like scales (HF CLIP's
    initializer: q/k/v and fc2 W^-0.5 (2L)^-0.5, out-projection W^-0.5, fc1
    (2W)^-0.5, embeddings 0.02, text positions 0.01, projections W^-0.5;
    biases 0.02; LayerNorm scales 1 + 0.02 noise)."""
    specs = [("logit_scale", (), 0.0, 2.6592)]

    def ln(prefix, w):
        specs.extend([(f"{prefix}.scale", (w,), 0.02, 1.0), (f"{prefix}.bias", (w,), 0.02, 0.0)])

    def blocks(tower, w, layers):
        in_std = w ** -0.5 * (2 * layers) ** -0.5
        for i in range(layers):
            p = f"{tower}.blocks.{i}."
            ln(p + "ln1", w)
            for proj, std in (("q_proj", in_std), ("k_proj", in_std), ("v_proj", in_std),
                              ("out_proj", w ** -0.5)):
                specs.append((f"{p}attn.{proj}.kernel", (w, w), std, 0.0))
                specs.append((f"{p}attn.{proj}.bias", (w,), 0.02, 0.0))
            ln(p + "ln2", w)
            specs.extend([(f"{p}mlp.fc1.kernel", (w, 4 * w), (2 * w) ** -0.5, 0.0),
                          (f"{p}mlp.fc1.bias", (4 * w,), 0.02, 0.0),
                          (f"{p}mlp.fc2.kernel", (4 * w, w), in_std, 0.0),
                          (f"{p}mlp.fc2.bias", (w,), 0.02, 0.0)])

    vw, tw, p = model["vision_width"], model["text_width"], model["patch_size"]
    n = (model["image_size"] // p) ** 2
    specs.extend([("vision.patch_embed.kernel", (p, p, 3, vw), 1.0 / math.sqrt(p * p * 3), 0.0),
                  ("vision.class_embedding", (vw,), 0.02, 0.0),
                  ("vision.position_embedding", (n + 1, vw), 0.02, 0.0)])
    ln("vision.pre_ln", vw)
    blocks("vision", vw, model["vision_layers"])
    ln("vision.post_ln", vw)
    specs.append(("vision.proj", (vw, model["embed_dim"]), vw ** -0.5, 0.0))
    specs.extend([("text.token_embedding", (model["vocab_size"], tw), 0.02, 0.0),
                  ("text.position_embedding", (model["context_length"], tw), 0.01, 0.0)])
    blocks("text", tw, model["text_layers"])
    ln("text.final_ln", tw)
    specs.append(("text.proj", (tw, model["embed_dim"]), tw ** -0.5, 0.0))
    return specs


def make_weights(model: dict, seed: int, device) -> dict:
    """The f32 weights of both towers, made on `device` by one draw of
    standard normals, scaled per tensor in place."""
    specs = weight_specs(model)
    total = sum(math.prod(s) for _, s, _, _ in specs)
    flat = torch.randn(total, generator=_generator(seed, "weights", device), device=device)
    out, off = {}, 0
    for name, shape, std, mean in specs:
        n = math.prod(shape)
        t = flat[off: off + n].view(shape)
        t.mul_(std).add_(mean)
        out[name] = t
        off += n
    return out


# -- the gallery ---------------------------------------------------------------


def make_gallery(n: int, d: int, seed: int, device, chunk: int, mag_range) -> tuple:
    """`n` f32 unit rows of dimension `d` and their magnitudes, uniform in
    `mag_range`, made on `device` `chunk` rows at a time and copied to the
    host: (rows (n, d) f32, magnitudes (n,) f32) as numpy arrays."""
    g = _generator(seed, "gallery", device)
    rows = np.empty((n, d), np.float32)
    mags = np.empty((n,), np.float32)
    lo_m, hi_m = (float(x) for x in mag_range)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        x = torch.randn((hi - lo, d), generator=g, device=device)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        rows[lo:hi] = x.cpu().numpy()
        m = torch.rand((hi - lo,), generator=g, device=device) * (hi_m - lo_m) + lo_m
        mags[lo:hi] = m.cpu().numpy()
    return rows, mags


def row_path(i: int) -> str:
    """The path the index stores for gallery row `i`."""
    return f"g/{i}.jpg"


def path_row(path: str) -> int:
    """The gallery row of a served path (-1 for one the benchmark never made)."""
    if path.startswith("g/") and path.endswith(".jpg"):
        try:
            return int(path[2:-4])
        except ValueError:
            return -1
    return -1


# -- pixels ------------------------------------------------------------------


def make_pixels(pool: int, batch: int, size: int, seed: int, device) -> np.ndarray:
    """(pool, batch, size, size, 3) uint8 RGB noise, made on `device`."""
    g = _generator(seed, "pixels", device)
    out = np.empty((pool, batch, size, size, 3), np.uint8)
    for i in range(pool):
        out[i] = torch.randint(0, 256, (batch, size, size, 3), generator=g, device=device,
                               dtype=torch.uint8).cpu().numpy()
    return out


# -- query texts ---------------------------------------------------------------


class QueryTexts:
    """Short English prompts, one for each request id, all distinct up to
    `len(self)` ids: request g takes sentence (a g + b) mod M of the product
    of the mix's word lists (every template holds every slot, so distinct
    sentence numbers give distinct sentences), with a and b drawn from the
    seed and a coprime to M. Words repeat across requests; sentences do not."""

    SLOTS = ("adjectives", "colours", "categories", "scenes")

    def __init__(self, texts: dict, seed: int):
        self.templates = list(texts["templates"])
        self.lists = [list(texts[s]) for s in self.SLOTS]
        self.size = len(self.templates) * math.prod(len(x) for x in self.lists)
        rng = np.random.default_rng(derive(seed, "texts"))
        while True:
            a = int(rng.integers(1, self.size))
            if math.gcd(a, self.size) == 1:
                break
        self.a, self.b = a, int(rng.integers(0, self.size))

    def __len__(self) -> int:
        return self.size

    def __call__(self, g: int) -> str:
        k = (self.a * int(g) + self.b) % self.size
        words = {}
        for slot, options in zip(self.SLOTS, self.lists):
            k, j = divmod(k, len(options))
            words[slot] = options[j]
        return self.templates[k].format(**words)
