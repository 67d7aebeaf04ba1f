"""pyvisim_tpu_torch.ops — functional compute cores in PyTorch.

Port of ``pyvisim_tpu/ops`` for deep features and SIFT/RootSIFT (``ops.sift``)
-> VLAD / Fisher vectors -> retrieval, vocabulary training and spectral
clustering. The TPU kernels on those paths are CUDA
kernels in ``ops/cuda``, the fused conv + ReLU + pool kernels of the int8
VGG trunk (``ops.cuda.conv``) among them.
"""
from .codebooks import (
    GmmCodebook,
    KMeansCodebook,
    PcaProjector,
    load_codebook,
    save_codebook,
    validate_codebook,
)
from .assign import gmm_log_prob, gmm_posteriors, nearest_centroid, pairwise_sqdist
from .norms import lp_norm, lp_normalize, power_normalize
from .vlad import vlad_aggregate, vlad_encode, vlad_encode_batch
from .fisher import fisher_encode, fisher_encode_batch, fisher_stats
from .similarity import cosine_similarity_matrix, pairwise_euclidean
from .kmeans import kmeans_fit, kmeans_plus_plus_init, lloyd_step
from .gmm import em_step, gmm_fit
from .pca import pca_fit, projector_from_moments
from .gaussian import gaussian_blur, gaussian_blur_batch
from .spectral import knn_affinity, spectral_cluster, spectral_embedding

__all__ = [
    "GmmCodebook",
    "KMeansCodebook",
    "PcaProjector",
    "load_codebook",
    "save_codebook",
    "validate_codebook",
    "gmm_log_prob",
    "gmm_posteriors",
    "nearest_centroid",
    "pairwise_sqdist",
    "lp_norm",
    "lp_normalize",
    "power_normalize",
    "vlad_aggregate",
    "vlad_encode",
    "vlad_encode_batch",
    "fisher_encode",
    "fisher_encode_batch",
    "fisher_stats",
    "cosine_similarity_matrix",
    "pairwise_euclidean",
    "kmeans_fit",
    "kmeans_plus_plus_init",
    "lloyd_step",
    "em_step",
    "gmm_fit",
    "pca_fit",
    "projector_from_moments",
    "gaussian_blur",
    "gaussian_blur_batch",
    "spectral_embedding",
    "spectral_cluster",
    "knn_affinity",
]
