"""Encoder API base: weights registry, validation, and the shared engine.

Port of ``pyvisim_tpu/encoders/_base_encoder.py`` for the main path:
encoders hold codebooks of tensors (``ops/codebooks.py``) on their
device, and ``encode`` runs extract -> PCA -> aggregate -> normalise on
the whole batch at once. Vocabulary learning, the multi-device paths and
the encoding maps come with later slices.
"""
from __future__ import annotations

import abc
import functools
import warnings
from collections.abc import Iterator, MutableSequence
from enum import Enum
from functools import wraps
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch

from .._base_classes import FeatureExtractorBase, SimilarityMetric
from .._config import MODEL_FILES_PATH, get_logger, resolve_device
from .._errors import WeightsNotFoundError
from .._utils import cosine_similarity
from ..ops import codebooks as cb

logger = get_logger("encoders")


def check_desired_output(
    similarity_func: Callable[[np.ndarray, np.ndarray], Any],
    vecs1: np.ndarray,
    vecs2: np.ndarray,
) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Decide whether ``similarity_func`` can batch over row matrices.

    The callable is probed once with ``(vecs1, vecs2)``. It is kept as-is
    only when the probe yields an array compatible with the matrix
    contract (shape ``(len(vecs1), len(vecs2))`` for 2-D output, or a
    single element for lower-rank output); otherwise it is wrapped in a
    row-pair adapter.
    """
    why = _probe_batch_support(similarity_func, vecs1, vecs2)
    if why is None:
        return similarity_func
    warnings.warn(f"{why} — wrapping the similarity function in a row-pair loop.")
    return _rowwise_adapter(similarity_func)


def _probe_batch_support(
    similarity_func: Callable[[np.ndarray, np.ndarray], Any],
    vecs1: np.ndarray,
    vecs2: np.ndarray,
) -> Optional[str]:
    """Run one batched probe; return None if OK, else a reason string."""
    try:
        probe = similarity_func(vecs1, vecs2)
    except Exception as exc:  # noqa: BLE001 - any failure means "can't batch"
        return f"Similarity probe raised {type(exc).__name__}: {exc}"
    if torch.is_tensor(probe):
        probe = probe.detach().cpu().numpy()
    if not isinstance(probe, np.ndarray):
        return f"Similarity probe returned {type(probe).__name__}, not an ndarray"
    want = (vecs1.shape[0], vecs2.shape[0])
    if probe.ndim == 2 and probe.shape != want:
        return f"Similarity probe returned shape {probe.shape}; expected {want}"
    if probe.ndim == 1 and probe.size != 1:
        return f"Similarity probe returned a length-{probe.size} vector; expected {want}"
    return None


def _rowwise_adapter(
    sim_func: Callable[[np.ndarray, np.ndarray], Any]
) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Adapt a pairwise-only similarity callable to the (N, D) x (M, D) ->
    (N, M) matrix contract by evaluating one row pair at a time."""

    def adapted(vecs1: np.ndarray, vecs2: np.ndarray) -> np.ndarray:
        n, m = vecs1.shape[0], vecs2.shape[0]
        pairs = (
            float(sim_func(vecs1[i, None], vecs2[j, None]))
            for i in range(n)
            for j in range(m)
        )
        return np.fromiter(pairs, dtype=np.float32, count=n * m).reshape(n, m)

    return adapted


def _tupleize_first_arg(func: Callable) -> Callable:
    """Convert an iterator/list first argument to a tuple (hashable)."""

    @wraps(func)
    def wrapper(self, image_paths: Any, /, *args, **kwargs):
        if isinstance(image_paths, (Iterator, MutableSequence)):
            image_paths = tuple(image_paths)
        return func(self, image_paths, *args, **kwargs)

    return wrapper


class _PretrainedModels(Enum):
    """Enum of pretrained codebook files (``.npz``), read in place from the
    JAX package's ``res/model_files``."""

    def load(self):
        path = MODEL_FILES_PATH / self.value
        if not path.exists():
            raise WeightsNotFoundError(
                f"Pretrained weights artifact {path.name} is not available in "
                "this build. Train a vocabulary with the JAX package's "
                "encoder.learn(...) instead."
            )
        with np.load(path, allow_pickle=False) as data:
            prov = str(data["__provenance__"]) if "__provenance__" in data.files else ""
        if "synthetic" in prov.lower():
            logger.warning(
                "Pretrained artifact %s (%s) was self-trained on a synthetic "
                "corpus, NOT Oxford-102 — retrieval quality will differ "
                "materially from the reference's pretrained weights. "
                "[provenance: %s]",
                path.name,
                self.name,
                prov,
            )
        return cb.load_codebook(path)

    @property
    def available(self) -> bool:
        return (MODEL_FILES_PATH / self.value).exists()


class KMeansWeights(_PretrainedModels):
    """K-Means vocabularies. The SIFT/RootSIFT files are self-trained; the
    VGG16 ones are not shipped."""

    OXFORD102_K256_VGG16_PCA = "k_means_k256_deep_features_vgg16_pca.npz"
    OXFORD102_K256_VGG16 = "k_means_k256_deep_features_vgg16_no_pca.npz"
    OXFORD102_K256_ROOTSIFT_PCA = "k_means_k256_root_sift_pca.npz"
    OXFORD102_K256_ROOTSIFT = "k_means_k256_root_sift_no_pca.npz"
    OXFORD102_K256_SIFT_PCA = "k_means_k256_sift_pca.npz"
    OXFORD102_K256_SIFT = "k_means_k256_sift_no_pca.npz"


class _PCA(_PretrainedModels):
    OXFORD102_PCA256_VGG16 = "pca_k256_deep_features_vgg16_f2.npz"
    OXFORD102_PCA256_ROOTSIFT = "pca_k256_root_sift_f2.npz"
    OXFORD102_PCA256_SIFT = "pca_k256_sift_f2.npz"


class GMMWeights(_PretrainedModels):
    """GMM vocabularies."""

    OXFORD102_K256_VGG16_PCA = "gmm_k256_deep_features_vgg16_pca.npz"
    OXFORD102_K256_VGG16 = "gmm_k256_deep_features_vgg16_no_pca.npz"
    OXFORD102_K256_ROOTSIFT_PCA = "gmm_k256_root_sift_pca.npz"
    OXFORD102_K256_ROOTSIFT = "gmm_k256_root_sift_no_pca.npz"
    OXFORD102_K256_SIFT_PCA = "gmm_k256_sift_pca.npz"
    OXFORD102_K256_SIFT = "gmm_k256_sift_no_pca.npz"


_CLUSTERING_TO_PCA_MAPPING = {
    KMeansWeights.OXFORD102_K256_VGG16_PCA: _PCA.OXFORD102_PCA256_VGG16,
    KMeansWeights.OXFORD102_K256_ROOTSIFT_PCA: _PCA.OXFORD102_PCA256_ROOTSIFT,
    KMeansWeights.OXFORD102_K256_SIFT_PCA: _PCA.OXFORD102_PCA256_SIFT,
    GMMWeights.OXFORD102_K256_VGG16_PCA: _PCA.OXFORD102_PCA256_VGG16,
    GMMWeights.OXFORD102_K256_ROOTSIFT_PCA: _PCA.OXFORD102_PCA256_ROOTSIFT,
    GMMWeights.OXFORD102_K256_SIFT_PCA: _PCA.OXFORD102_PCA256_SIFT,
}


def _coerce_pca(pca: Any) -> cb.PcaProjector:
    if isinstance(pca, cb.PcaProjector):
        return pca
    if hasattr(pca, "components_"):
        return cb.PcaProjector.from_sklearn(pca)
    raise TypeError(f"Cannot interpret {type(pca)} as a PCA projector.")


class ImageEncoderBase(SimilarityMetric):
    """Base class for image encoders.

    Public surface as the JAX package's: ``encode``, ``similarity_score``,
    settable ``similarity_func`` / ``pca`` / ``clustering_model`` /
    ``feature_extractor``, ``power_norm_weight``, ``norm_order``,
    ``epsilon``, ``flatten``. Subclasses implement
    ``_encode_core(desc, mask, clustering_model, pca)`` on batched tensors.

    ``device``: where codebooks live and encoding runs; None takes the
    feature extractor's device, and CUDA if it has none.
    ``similarity_func`` None means cosine similarity on that device.
    """

    _vocabulary_kind: str = ""

    def __init__(
        self,
        feature_extractor: FeatureExtractorBase = None,
        weights: Union[KMeansWeights, GMMWeights, None] = None,
        clustering_model=None,
        similarity_func: Callable[[np.ndarray, np.ndarray], float] = None,
        power_norm_weight: float = 1.0,
        norm_order: float = 2.0,
        epsilon: float = 1e-9,
        flatten: bool = True,
        pca: Optional[Any] = None,
        raise_error_when_pca_incompatible: bool = True,
        device=None,
    ):
        self._feature_extractor = None
        self._clustering_model = None
        self._pca = None
        self._similarity_func = None
        if device is None:
            device = getattr(feature_extractor, "device", None)
        self.device = resolve_device(device)

        self.similarity_func = similarity_func
        self.feature_extractor = feature_extractor

        if weights is not None:
            if "PCA" in weights.name:
                self.pca = _CLUSTERING_TO_PCA_MAPPING[weights].load()
            self.clustering_model = weights.load()
        else:
            if pca is not None:
                self.pca = pca
            if clustering_model is not None:
                self.clustering_model = clustering_model

        self._power_norm_weight = float(power_norm_weight)
        self._norm_order = float(norm_order)
        self._epsilon = float(epsilon)
        self._flatten = bool(flatten)
        self.raise_error_when_pca_incompatible = raise_error_when_pca_incompatible

    @property
    def power_norm_weight(self) -> float:
        return self._power_norm_weight

    @power_norm_weight.setter
    def power_norm_weight(self, v: float):
        self._power_norm_weight = float(v)

    @property
    def norm_order(self) -> float:
        return self._norm_order

    @norm_order.setter
    def norm_order(self, v: float):
        self._norm_order = float(v)

    @property
    def epsilon(self) -> float:
        return self._epsilon

    @epsilon.setter
    def epsilon(self, v: float):
        self._epsilon = float(v)

    @property
    def flatten(self) -> bool:
        return self._flatten

    @flatten.setter
    def flatten(self, v: bool):
        self._flatten = bool(v)

    @property
    def feature_extractor(self) -> FeatureExtractorBase:
        return self._feature_extractor

    @feature_extractor.setter
    def feature_extractor(self, feature_extractor: FeatureExtractorBase):
        if not isinstance(feature_extractor, FeatureExtractorBase):
            raise TypeError(
                "feature_extractor must be an instance of FeatureExtractorBase, "
                f"not {type(feature_extractor)}"
            )
        if self._pca is not None:
            if feature_extractor.output_dim != self._pca.n_features_in:
                raise RuntimeError(
                    f"Feature Extractor outputs shape {feature_extractor.output_dim}, "
                    f"But PCA accepts input dim {self._pca.n_features_in}"
                )
        elif self._clustering_model is not None:
            if feature_extractor.output_dim != self._clustering_model.n_features_in:
                raise RuntimeError(
                    f"Feature Extractor outputs shape {feature_extractor.output_dim}, "
                    "But clustering model accepts input dim "
                    f"{self._clustering_model.n_features_in}"
                )
        self._feature_extractor = feature_extractor

    @property
    def similarity_func(self):
        return self._similarity_func

    @similarity_func.setter
    def similarity_func(self, func: Callable[[np.ndarray, np.ndarray], float]):
        if func is None:
            func = functools.partial(cosine_similarity, device=self.device)
        dummy1, dummy2 = np.random.rand(10, 10), np.random.rand(10, 10)
        self._similarity_func = check_desired_output(func, dummy1, dummy2)

    @property
    def clustering_model(self):
        return self._clustering_model

    @clustering_model.setter
    def clustering_model(self, clustering_model):
        clustering_model = self._coerce_clustering_model(clustering_model)
        if self._pca:
            if self._pca.n_components != clustering_model.n_features_in:
                if self.raise_error_when_pca_incompatible:
                    raise RuntimeError(
                        "PCA is incompatible with the new clustering model. "
                        f"PCA output size: {self._pca.n_components}, "
                        f"New clustering model input size: {clustering_model.n_features_in}. "
                        "If you want the PCA to be reset to None instead, set "
                        "raise_error_when_pca_incompatible=False."
                    )
                warnings.warn(
                    "PCA is incompatible with the new clustering model. "
                    f"PCA output size: {self._pca.n_components}, "
                    f"New clustering model input size: {clustering_model.n_features_in}. "
                    "PCA will be reset to None to avoid errors."
                )
                self._pca = None
        elif self._feature_extractor is not None:
            if self._feature_extractor.output_dim != clustering_model.n_features_in:
                raise RuntimeError(
                    "Feature extractor output size has to match the clustering "
                    "model input size. Feature extractor has output size "
                    f"{self._feature_extractor.output_dim}, while clustering "
                    f"model has input size {clustering_model.n_features_in}"
                )
        self._clustering_model = clustering_model.to(self.device)

    @property
    def pca(self) -> Optional[cb.PcaProjector]:
        return self._pca

    @pca.setter
    def pca(self, pca):
        pca = _coerce_pca(pca)
        if (
            self._feature_extractor is not None
            and pca.n_features_in != self._feature_extractor.output_dim
        ):
            raise ValueError(
                "PCA input size has to match the feature extractor output size. "
                f"PCA model has input size {pca.n_features_in}, while feature "
                f"extractor has output size {self._feature_extractor.output_dim}"
            )
        if (
            self._clustering_model is not None
            and pca.n_components != self._clustering_model.n_features_in
        ):
            raise ValueError(
                "PCA output size has to match the clustering model input size. "
                f"PCA model has output size {pca.n_components}, while clustering "
                f"model has input size {self._clustering_model.n_features_in}"
            )
        self._pca = pca.to(self.device)

    @abc.abstractmethod
    def _coerce_clustering_model(self, model):
        raise NotImplementedError

    def _encode_core(
        self, desc: torch.Tensor, mask: torch.Tensor, clustering_model, pca
    ) -> torch.Tensor:
        """Batched core: ``(B, N, D_raw) -> (B, out)``. Subclasses apply
        ``pca`` and their aggregation."""
        raise NotImplementedError

    def encode(self, images: Iterable[np.ndarray] | np.ndarray) -> np.ndarray:
        """Encode one or more images into vectors, as one device batch.

        Returns ``(B, dim)`` when ``flatten`` else the per-image matrices
        stacked along axis 0.
        """
        if torch.is_tensor(images):
            raise RuntimeError("Torch images are not supported yet.")
        if self._clustering_model is None:
            raise RuntimeError(
                "No clustering model set. Pass weights= or clustering_model=."
            )
        desc, mask = self.feature_extractor.extract_batch(images)
        out = self._encode_descriptors(desc, mask)
        if not self._flatten and out.ndim == 3:
            out = out.reshape(-1, out.shape[-1])
        return out

    def _encode_descriptors(self, desc, mask) -> np.ndarray:
        """Run the encode core on an extracted ``(B, N, D)/(B, N)`` batch
        (numpy or tensors) on the encoder's device; numpy out."""
        desc = torch.as_tensor(desc, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        with torch.inference_mode():
            out = self._encode_core(desc, mask, self._clustering_model, self._pca)
        return out.cpu().numpy()

    def similarity_score(
        self,
        images1: Iterable[np.ndarray] | np.ndarray,
        images2: Iterable[np.ndarray] | np.ndarray,
    ) -> np.ndarray:
        """Encode both batches and apply ``similarity_func``."""
        vector1 = self.encode(images1)
        vector2 = self.encode(images2)
        return np.float32(self.similarity_func(vector1, vector2))

    def __repr__(self) -> str:
        n_clusters = None
        m = self._clustering_model
        if m is not None:
            n_clusters = getattr(m, "n_clusters", None) or getattr(m, "n_components", None)
        sim_name = getattr(self.similarity_func, "__name__", str(self.similarity_func))
        return (
            f"{type(self).__name__}(feature_extractor="
            f"{type(self.feature_extractor).__name__}, \n"
            f"similarity_func={sim_name}, \n"
            f"Number of cluster={n_clusters}, \n"
            f"Power Norm Weight={self.power_norm_weight}, \n"
            f"Norm Order={self.norm_order})"
        )
