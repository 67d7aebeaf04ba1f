"""pyvisim_tpu_torch.ops — functional compute cores in PyTorch.

Port of ``pyvisim_tpu/ops`` for the main path (deep features -> VLAD ->
retrieval). The TPU kernel on that path is a CUDA kernel in ``ops/cuda``.
"""
from .codebooks import (
    GmmCodebook,
    KMeansCodebook,
    PcaProjector,
    load_codebook,
    save_codebook,
    validate_codebook,
)
from .assign import nearest_centroid, pairwise_sqdist
from .norms import lp_norm, lp_normalize, power_normalize
from .vlad import vlad_aggregate, vlad_encode, vlad_encode_batch
from .similarity import cosine_similarity_matrix, pairwise_euclidean

__all__ = [
    "GmmCodebook",
    "KMeansCodebook",
    "PcaProjector",
    "load_codebook",
    "save_codebook",
    "validate_codebook",
    "nearest_centroid",
    "pairwise_sqdist",
    "lp_norm",
    "lp_normalize",
    "power_normalize",
    "vlad_aggregate",
    "vlad_encode",
    "vlad_encode_batch",
    "cosine_similarity_matrix",
    "pairwise_euclidean",
]
