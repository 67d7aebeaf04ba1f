"""VLADEncoder: the stateful API over the VLAD core.

Port of ``pyvisim_tpu/encoders/vlad.py``: features -> PCA -> assign ->
aggregate -> normalise for the whole batch, through
``ops.vlad.vlad_encode_batch`` (one aggregation kernel call on CUDA).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .._base_classes import FeatureExtractorBase
from ..ops.codebooks import KMeansCodebook
from ..ops.vlad import vlad_encode_batch
from ._base_encoder import ImageEncoderBase, KMeansWeights

__all__ = ["VLADEncoder"]


class VLADEncoder(ImageEncoderBase):
    """Encodes images into VLAD vectors using a feature extractor and a
    K-Means vocabulary, and compares them with a similarity function.

    Same constructor surface as the JAX package's VLADEncoder, plus
    ``device``; ``kmeans_model`` accepts a :class:`KMeansCodebook` or a
    fitted sklearn ``KMeans``. Output dim is ``K * D``. The JAX package's
    default extractor, RootSIFT, is not ported yet, so an extractor must
    be given.

    References:
    ===========
    [1] Arandjelovic & Zisserman, "All About VLAD".
    [2] Arandjelovic & Zisserman, "Three things everyone should know to
        improve object retrieval".
    [3] Jegou et al., "Aggregating Local Image Descriptors into Compact
        Codes".
    """

    _vocabulary_kind = "kmeans"

    def __init__(
        self,
        feature_extractor: FeatureExtractorBase | None = None,
        weights: Optional[KMeansWeights] = None,
        kmeans_model=None,
        power_norm_weight: float = 1.0,
        norm_order: float = 2.0,
        epsilon: float = 1e-9,
        flatten: bool = True,
        similarity_func: Callable | None = None,
        pca=None,
        raise_error_when_pca_incompatible: bool = False,
        device=None,
    ) -> None:
        if feature_extractor is None:
            raise TypeError(
                "VLADEncoder needs a feature_extractor (the default RootSIFT "
                "is not ported to PyTorch yet)."
            )
        if weights is not None and weights.__class__.__name__ != "KMeansWeights":
            raise ValueError(
                "You can only pass an instance of KMeansWeights, "
                f"not {weights.__class__.__name__}"
            )
        super().__init__(
            feature_extractor,
            weights,
            kmeans_model,
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
        if isinstance(model, KMeansCodebook):
            return model
        if hasattr(model, "cluster_centers_"):
            return KMeansCodebook.from_sklearn(model)
        raise ValueError(
            f"The clustering model must be a KMeansCodebook or sklearn KMeans, "
            f"not {type(model)}"
        )

    def _encode_core(self, desc, mask, clustering_model, pca):
        desc = desc.to(torch.float32)
        if pca is not None:
            desc = pca(desc)
        return vlad_encode_batch(
            desc,
            mask,
            clustering_model.centers,
            power_norm_weight=self._power_norm_weight,
            norm_order=self._norm_order,
            epsilon=self._epsilon,
            flatten=self._flatten,
        )
