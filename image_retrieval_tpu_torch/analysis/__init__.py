"""The color-analysis engine: MI between geometric metrics of CLIP
embeddings and color/object relationships (port of
``image_retrieval_tpu/analysis``)."""

from image_retrieval_tpu_torch.analysis.color_mi import ColorMIAnalyzer, analyze_color_embeddings  # noqa: F401
from image_retrieval_tpu_torch.analysis.pair_mi import PairMIAnalysis, EnhancedPairMIAnalysis  # noqa: F401
