"""FisherVectorEncoder: the stateful API over the Fisher Vector core.

Port of ``pyvisim_tpu/encoders/fisher_vector.py``: features -> PCA ->
GMM posteriors and statistics -> Fisher vector -> normalise for the whole
batch, through ``ops.fisher.fisher_encode_batch`` (one GMM-statistics
kernel call on CUDA), with the reference's sign-flipped ``d_sigma``.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from .._base_classes import FeatureExtractorBase
from ..features import RootSIFT
from ..ops.codebooks import GmmCodebook
from ..ops.fisher import fisher_encode_batch
from ._base_encoder import GMMWeights, ImageEncoderBase

__all__ = ["FisherVectorEncoder"]


class FisherVectorEncoder(ImageEncoderBase):
    """Encodes images into Fisher Vectors from a diagonal-GMM vocabulary,
    and compares them with a similarity function.

    Same constructor surface as the JAX package's FisherVectorEncoder, plus
    ``device``; ``gmm_model`` accepts a :class:`GmmCodebook` or a fitted
    sklearn ``GaussianMixture`` (a non-diag one is converted as diagonal,
    with a warning). Output dim is ``2*K*D + K``. The default extractor is
    ``RootSIFT(device=device)``.

    References:
    ===========
    [1] Jegou et al., "Aggregating Local Image Descriptors into Compact
        Codes".
    """

    _vocabulary_kind = "gmm"

    def __init__(
        self,
        feature_extractor: FeatureExtractorBase | None = None,
        weights: Optional[GMMWeights] = None,
        gmm_model=None,
        power_norm_weight: float = 0.5,
        norm_order: float = 2.0,
        epsilon: float = 1e-9,
        flatten: bool = True,
        similarity_func: Callable | None = None,
        pca=None,
        raise_error_when_pca_incompatible: bool = False,
        device=None,
    ):
        if feature_extractor is None:
            feature_extractor = RootSIFT(device=device)
        if weights is not None and weights.__class__.__name__ != "GMMWeights":
            raise ValueError(
                "You can only pass an instance of GMMWeights, "
                f"not {weights.__class__.__name__}"
            )
        super().__init__(
            feature_extractor,
            weights,
            gmm_model,
            similarity_func,
            power_norm_weight,
            norm_order,
            epsilon,
            flatten,
            pca,
            raise_error_when_pca_incompatible,
            device,
        )

    def _coerce_clustering_model(self, model):
        if isinstance(model, GmmCodebook):
            return model
        if hasattr(model, "covariances_"):
            if getattr(model, "covariance_type", "diag") != "diag":
                warnings.warn(
                    "Attribute 'covariance_type' of the clustering model must "
                    "be 'diag'; converting assumes diagonal covariances."
                )
            return GmmCodebook.from_sklearn(model)
        raise ValueError(
            f"The clustering model must be a GmmCodebook or sklearn "
            f"GaussianMixture, not {type(model)}"
        )

    def _encode_cluster_sharded(self, desc, mask, mesh):
        """The K component axis split over the mesh's 'cluster' axis: the
        posterior's normaliser comes from a max and a sum all-reduce
        (``parallel.cluster_sharded_fisher_encode``), after the PCA."""
        from ..parallel import cluster_sharded_fisher_encode

        desc = desc.to(torch.float32)
        if self._pca is not None:
            desc = self._pca(desc)
        out = cluster_sharded_fisher_encode(
            desc,
            mask,
            self._clustering_model,
            mesh,
            power_norm_weight=self._power_norm_weight,
            norm_order=self._norm_order,
            epsilon=self._epsilon,
        )
        # The replicated core's un-flattened row-vector shape.
        return out if self._flatten else out[:, None, :]

    def _encode_core(self, desc, mask, clustering_model, pca):
        desc = desc.to(torch.float32)
        if pca is not None:
            desc = pca(desc)
        return fisher_encode_batch(
            desc,
            mask,
            clustering_model,
            power_norm_weight=self._power_norm_weight,
            norm_order=self._norm_order,
            epsilon=self._epsilon,
            flatten=self._flatten,
        )
