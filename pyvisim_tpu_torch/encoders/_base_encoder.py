"""Encoder API base: weights registry, validation, and the shared engine.

Port of ``pyvisim_tpu/encoders/_base_encoder.py``: encoders hold
codebooks of tensors (``ops/codebooks.py``) on their device, ``encode``
runs extract -> PCA -> aggregate -> normalise on the whole batch at once,
and ``learn`` trains the PCA and the K-Means or GMM vocabulary on the
device. Extractors with a device-resident variant (SIFT/RootSIFT) hand
their descriptors to the encode core on the device. ``generate_encoding_map``
decodes image files on a prefetch thread and encodes them in batches, into a
``{path: vector}`` dict or an HDF5 file. An encoder on a mesh (its own
``mesh``, else its extractor's) encodes with the batch split over 'data'
(``parallel.sharded_encode``; on its extractor's own mesh each rank
extracts and encodes its block alone, ``extract_block``) or, with a
'cluster' axis, with the K axis
split too (``parallel.cluster_sharded_*_encode``), and ``learn`` fits on
the mesh (``parallel.distributed_*_fit``).
"""
from __future__ import annotations

import abc
import functools
import os
import warnings
from collections.abc import Iterator, MutableSequence
from enum import Enum
from functools import wraps
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch

from .. import profiling
from .._base_classes import FeatureExtractorBase, SimilarityMetric
from .._config import MODEL_FILES_PATH, get_logger, resolve_device
from .._errors import WeightsNotFoundError
from .._utils import cosine_similarity
from ..io._staging import readback
from ..ops import codebooks as cb
from ..ops import gmm as gmm_ops
from ..ops import kmeans as kmeans_ops
from ..ops import pca as pca_ops

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


_SINGLE_CHIP_FIT_KWARGS = frozenset({"chunk_size", "init_subsample", "tol", "kmeans_iters"})


def _mesh_fit_kwargs(kwargs: dict) -> dict:
    """Translate single-card fit kwargs for the distributed fitters:
    ``max_iters`` becomes ``n_iters``; knobs that exist only on the
    single-card path are dropped with a log note."""
    out = {}
    for key, value in kwargs.items():
        if key == "max_iters":
            out["n_iters"] = value
        elif key in _SINGLE_CHIP_FIT_KWARGS:
            logger.info("learn() on a mesh ignores single-card kwarg %r", key)
        else:
            out[key] = value
    return out


def _tupleize_first_arg(func: Callable) -> Callable:
    """Convert an iterator/list first argument to a tuple (hashable)."""

    @wraps(func)
    def wrapper(self, image_paths: Any, /, *args, **kwargs):
        if isinstance(image_paths, (Iterator, MutableSequence)):
            image_paths = tuple(image_paths)
        return func(self, image_paths, *args, **kwargs)

    return wrapper


def extract_for_encoding(extractor: FeatureExtractorBase, images):
    """An extractor's ``(desc, mask)`` for an encode that follows on the
    device: its device-resident variant where it has one (SIFT/RootSIFT),
    so the descriptors need no copy to the host and back."""
    if hasattr(extractor, "extract_batch_device"):
        return extractor.extract_batch_device(images)
    return extractor.extract_batch(images)


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
        with profiling.span("init"):
            self._feature_extractor = None
            self._clustering_model = None
            self._pca = None
            self._similarity_func = None
            self._mesh_override = None
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

    @property
    def mesh(self):
        """The mesh the encode runs on: one assigned to the encoder
        (``encoder.mesh = m``) first, else the feature extractor's.

        A mesh with a 'cluster' axis also splits the K centroid/component
        axis over the ranks (``parallel.cluster_sharded_vlad_encode``).
        """
        if self._mesh_override is not None:
            return self._mesh_override
        return getattr(self._feature_extractor, "mesh", None)

    @mesh.setter
    def mesh(self, mesh):
        self._mesh_override = mesh

    @abc.abstractmethod
    def _coerce_clustering_model(self, model):
        raise NotImplementedError

    def _encode_core(
        self, desc: torch.Tensor, mask: torch.Tensor, clustering_model, pca
    ) -> torch.Tensor:
        """Batched core: ``(B, N, D_raw) -> (B, out)``. Subclasses apply
        ``pca`` and their aggregation."""
        raise NotImplementedError

    def encode(self, images: Iterable[np.ndarray] | np.ndarray | torch.Tensor) -> np.ndarray:
        """Encode one or more images into vectors, as one device batch.

        ``images``: uint8 HWC numpy images, or a ``(B, H, W, 3)`` tensor
        batch (e.g. from ``io.prefetch_to_device``) where the extractor
        takes one (``DeepConvFeature``). Returns ``(B, dim)`` when
        ``flatten`` else the per-image matrices stacked along axis 0.
        """
        if self._clustering_model is None:
            raise RuntimeError(
                "No clustering model set. Pass weights= or clustering_model=."
            )
        with profiling.span("encode", root=True):
            out = self._encode_descriptors(*self._extract(images))
        if not self._flatten and out.ndim == 3:
            out = out.reshape(-1, out.shape[-1])
        return out

    def _encodes_blocks(self) -> bool:
        """Whether the extractor hands this encode each rank's block alone:
        the encoder runs on its extractor's own mesh, split over 'data'
        only, and the extractor has ``extract_block``."""
        mesh = self.mesh
        return (mesh is not None and mesh is getattr(self._feature_extractor, "mesh", None)
                and hasattr(self._feature_extractor, "extract_block")
                and "cluster" not in (mesh.mesh_dim_names or ()))

    def _extract(self, images) -> tuple:
        """``(desc, mask, n)`` for ``_encode_descriptors``: the rank's block
        and the batch's size where ``_encodes_blocks``, else the whole batch
        and None."""
        if self._encodes_blocks():
            return self._feature_extractor.extract_block(images)
        return (*extract_for_encoding(self._feature_extractor, images), None)

    def _encode_descriptors(self, desc, mask, n: int | None = None) -> np.ndarray:
        """Run the encode core on an extracted ``(B, N, D)/(B, N)`` batch
        (numpy or tensors) on the encoder's device, or on its mesh; numpy
        out. With ``n``, ``desc``/``mask`` are this rank's block of a batch
        of ``n`` images (``extract_block``). The one engine of ``encode``
        and ``Pipeline.encode``."""
        mesh = self.mesh
        if n is not None:
            from ..parallel.sharded import _encode_block

            with torch.inference_mode(), profiling.span("aggregate"):
                out = _encode_block(self._encode_core, desc, mask, self._clustering_model,
                                   self._pca, mesh, n)
            return _readback(out)
        desc = torch.as_tensor(desc, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        with torch.inference_mode(), profiling.span("aggregate"):
            if mesh is None:
                out = self._encode_core(desc, mask, self._clustering_model, self._pca)
            elif "cluster" in (mesh.mesh_dim_names or ()):
                out = self._encode_cluster_sharded(desc, mask, mesh)
            else:
                from ..parallel import sharded_encode

                out = sharded_encode(self._encode_core, desc, mask, self._clustering_model,
                                     self._pca, mesh)
        return _readback(out)

    def _encode_cluster_sharded(self, desc, mask, mesh) -> torch.Tensor:
        """Subclasses dispatch to their cluster-sharded encode."""
        raise NotImplementedError(
            f"{type(self).__name__} has no cluster-sharded encode; use a mesh without a "
            "'cluster' axis."
        )

    def learn(
        self,
        images: Iterable[np.ndarray],
        /,
        *,
        n_clusters: int,
        dim_reduction_factor: int | None = None,
        batch_size: int = 64,
        max_descriptors: int | None = None,
        seed: int = 0,
        **kwargs,
    ) -> None:
        """Learn the visual vocabulary (PCA + K-Means/GMM) from images on
        the encoder's device.

        Images stream through the extractor in ``batch_size`` chunks;
        ``max_descriptors`` caps the training set by sampling valid rows of
        each batch with ``np.random.default_rng(seed)``, as the JAX package
        does, so both train on the same rows of the same descriptors. With
        ``dim_reduction_factor`` a PCA to ``dim // dim_reduction_factor``
        is fitted on the raw descriptors first. ``kwargs`` go to
        ``kmeans_fit`` or ``gmm_fit``.

        On a mesh with a 'data' axis the PCA and the K-Means/GMM fits run
        there (``parallel.distributed_{pca,kmeans,gmm}_fit``): descriptor
        rows split over 'data' and the statistics are summed. ``max_iters``
        becomes their ``n_iters``; single-card knobs (``chunk_size``,
        ``tol``, ...) are dropped.
        """
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        images = list(images) if not isinstance(images, np.ndarray) else images
        n_batches = max(1, -(-len(images) // batch_size))
        per_batch_cap = (
            None if max_descriptors is None else max(1, max_descriptors // n_batches)
        )
        rng = np.random.default_rng(seed)
        desc_parts, mask_parts = [], []
        for start in range(0, len(images), batch_size):
            d_b, m_b = self.feature_extractor.extract_batch(
                images[start : start + batch_size]
            )
            d_b = torch.as_tensor(d_b, device=self.device).to(torch.float32)
            d_b = d_b.reshape(-1, d_b.shape[-1])
            m_b = torch.as_tensor(m_b, device=self.device).to(torch.float32).reshape(-1)
            n_valid = int(torch.count_nonzero(m_b))
            if n_valid == 0:
                continue  # nothing to learn from in this batch
            if per_batch_cap is not None and d_b.shape[0] > per_batch_cap:
                # Sample among valid rows only, on the host generator.
                m_np = m_b.cpu().numpy()
                idx = rng.choice(
                    d_b.shape[0],
                    size=min(per_batch_cap, n_valid),
                    replace=False,
                    p=m_np / m_np.sum(),
                )
                idx = torch.as_tensor(idx, device=self.device)
                d_b, m_b = d_b[idx], m_b[idx]
            desc_parts.append(d_b)
            mask_parts.append(m_b)
        if not desc_parts:
            raise RuntimeError(
                "learn(): no valid descriptors were extracted from any batch; "
                "cannot train a vocabulary"
            )
        flat = torch.cat(desc_parts)
        flat_mask = torch.cat(mask_parts)
        logger.info(
            "Learning visual vocabulary: n_clusters=%d extractor=%s dim=%d",
            n_clusters,
            type(self.feature_extractor).__name__,
            flat.shape[1],
        )
        mesh = self.mesh
        if mesh is not None and "data" in (mesh.mesh_dim_names or ()):
            from .. import parallel

            pca_fit = functools.partial(parallel.distributed_pca_fit, mesh=mesh)
            fits = {"kmeans": parallel.distributed_kmeans_fit, "gmm": parallel.distributed_gmm_fit}
            fit_kwargs = dict(_mesh_fit_kwargs(kwargs), mesh=mesh)
        else:
            pca_fit = functools.partial(pca_ops.pca_fit, device=self.device)
            fits = {"kmeans": kmeans_ops.kmeans_fit, "gmm": gmm_ops.gmm_fit}
            fit_kwargs = dict(kwargs, device=self.device)
        if dim_reduction_factor:
            projector = pca_fit(flat, flat.shape[1] // dim_reduction_factor, mask=flat_mask)
            self._pca = projector
            flat = projector(flat)
        if self._vocabulary_kind not in fits:
            raise ValueError("Unknown encoder class.")
        model, _ = fits[self._vocabulary_kind](flat, n_clusters, mask=flat_mask, **fit_kwargs)
        self._clustering_model = model

    @_tupleize_first_arg
    def generate_encoding_map(
        self,
        image_paths: Iterable[str],
        /,
        batch_size: int = 64,
        save_path: str | None = None,
    ) -> dict[str, np.ndarray] | None:
        """``{image_path: encoded_vector}`` for a collection of files.

        Images are decoded on the host (native loader where it builds, else
        OpenCV) on a prefetch thread and encoded in device batches; each
        batch's results come back to host memory, so a gallery pins no
        device memory.

        :param save_path: optional ``.h5`` file: each batch is appended to
            it instead of accumulating in RAM, and the method returns
            ``None``. Reload with :func:`load_encoding_map` (flat
            ``vectors``/``paths`` datasets, appendable).
        """
        return _encode_paths_to_map(self.encode, image_paths, batch_size, save_path)

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


def _readback(out: torch.Tensor) -> np.ndarray:
    """The encodings copied to host numpy, in the ``readback`` span."""
    with profiling.span("readback"):
        profiling.count("d2h_bytes", out.numel() * out.element_size())
        return readback(out)


def _encode_paths_to_map(
    encode_fn: Callable,
    image_paths: Iterable[str],
    batch_size: int,
    save_path: str | None,
) -> dict[str, np.ndarray] | None:
    """Shared engine of ``generate_encoding_map``: decode on the host, encode
    in device batches brought back to host numpy, and either build a
    ``{path: vector}`` dict or append to flat ``vectors`` / ``paths`` HDF5
    datasets in ``save_path`` (then return None)."""
    from ..io import PrefetchIterator, imread_rgb

    paths = list(image_paths)
    h5 = None
    vec_ds = path_ds = None
    if save_path is not None:
        if not paths:
            # The datasets are created at the first batch; an empty input
            # would write a file that fails to load.
            raise ValueError(
                "generate_encoding_map(save_path=...) needs at least one image path"
            )
        import h5py

        h5 = h5py.File(save_path, "w")
    result: dict[str, np.ndarray] = {}

    def decoded_chunks():
        for start in range(0, len(paths), batch_size):
            chunk = paths[start : start + batch_size]
            yield chunk, [imread_rgb(p) for p in chunk]

    try:
        # Batch i+1 decodes on the producer thread while batch i encodes
        # (the native and OpenCV decoders release the GIL).
        for chunk, imgs in PrefetchIterator(decoded_chunks(), depth=2, to_device=False):
            vecs = np.asarray(encode_fn(imgs))
            if h5 is not None:
                if vec_ds is None:
                    vec_ds = h5.create_dataset(
                        "vectors", shape=(0, vecs.shape[1]),
                        maxshape=(None, vecs.shape[1]), dtype=vecs.dtype, chunks=True,
                    )
                    path_ds = h5.create_dataset(
                        "paths", shape=(0,), maxshape=(None,), dtype=h5py.string_dtype(),
                    )
                n0 = vec_ds.shape[0]
                vec_ds.resize(n0 + len(chunk), axis=0)
                vec_ds[n0:] = vecs[: len(chunk)]
                path_ds.resize(n0 + len(chunk), axis=0)
                path_ds[n0:] = chunk
            else:
                for p, v in zip(chunk, vecs):
                    result[p] = v
    finally:
        if h5 is not None:
            h5.close()
    return None if save_path is not None else result


def load_encoding_map(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Load a ``{image_path: vector}`` map written by
    ``generate_encoding_map(..., save_path=...)`` in either stack."""
    from ..eval import _gallery

    paths, vectors = _gallery(os.fspath(path))
    return dict(zip(paths, vectors))
