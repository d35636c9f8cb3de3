"""image_retrieval_tpu_torch — the PyTorch/CUDA port of image_retrieval_tpu.

The JAX package beside it stays the reference; this package keeps its module
paths and public names so each counterpart is easy to find, and imports no
jax. The port covers the text->image serving slice so far:

- tokenizer, preprocessing and the decode loader              -> models/, data/
- CLIP ViT-B/32 towers with the int8 whole-layer serving path  -> models/clip.py
  (its layer is a hand-written Hopper kernel, csrc/layer_block_int8.cu)
- exact top-k with lowest-index ties                           -> ops/topk.py
- the resident f32 exact index                                 -> index/
- ingest, search and the micro-batching server                 -> app/
- contrastive training on one device                           -> train/
- the color analysis: binning and MI, the color dataset,       -> ops/, data/,
  the pair and color MI analyzers, the headless workflow          analysis/, app/

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise, and nothing falls back to the CPU.
ROADMAP.md lists what is still to be ported.
"""

__version__ = "0.1.0"

from image_retrieval_tpu_torch.config import Config, ModelConfig  # noqa: F401
