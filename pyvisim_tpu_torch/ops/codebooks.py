"""Codebooks: the statistical "vocabulary" models owned by encoders.

Port of ``pyvisim_tpu/ops/codebooks.py``: plain dataclasses of tensors
with ``.to(device)``, saved as ``.npz`` in the JAX package's layout, so a
file written by one package loads in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = [
    "KMeansCodebook",
    "GmmCodebook",
    "PcaProjector",
    "save_codebook",
    "load_codebook",
    "validate_codebook",
]


class _Codebook:
    """Shared behaviour: array fields become tensors; ``.to`` moves them."""

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None and not isinstance(v, bool):
                setattr(self, f.name, torch.as_tensor(v))

    def to(self, device) -> "_Codebook":
        changes = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class PcaProjector(_Codebook):
    """PCA projection ``y = (x - mean) @ components.T`` (+ optional whitening).

    mean: (D_in,), components: (D_out, D_in), explained_variance: (D_out,)
    """

    mean: torch.Tensor
    components: torch.Tensor
    explained_variance: torch.Tensor | None = None
    whiten: bool = False

    @property
    def n_features_in(self) -> int:
        return self.components.shape[1]

    @property
    def n_components(self) -> int:
        return self.components.shape[0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = (x - self.mean) @ self.components.T
        if self.whiten:
            y = y / torch.sqrt(self.explained_variance)
        return y

    @classmethod
    def from_sklearn(cls, pca: Any) -> "PcaProjector":
        return cls(
            mean=np.asarray(pca.mean_, np.float32),
            components=np.asarray(pca.components_, np.float32),
            explained_variance=np.asarray(pca.explained_variance_, np.float32),
            whiten=bool(getattr(pca, "whiten", False)),
        )

    def to_sklearn(self):
        """An equivalent fitted sklearn ``PCA``."""
        from sklearn.decomposition import PCA

        pca = PCA(n_components=self.n_components, whiten=self.whiten)
        pca.mean_ = self.mean.cpu().numpy().astype(np.float64)
        pca.components_ = self.components.cpu().numpy().astype(np.float64)
        ev = (
            np.ones(self.n_components)
            if self.explained_variance is None
            else self.explained_variance.cpu().numpy().astype(np.float64)
        )
        pca.explained_variance_ = ev
        pca.explained_variance_ratio_ = ev / max(ev.sum(), 1e-12)
        pca.singular_values_ = np.sqrt(np.maximum(ev, 0.0))
        pca.n_components_ = self.n_components
        pca.n_features_in_ = self.n_features_in
        pca.n_samples_ = self.n_components + 1
        pca.noise_variance_ = 0.0
        return pca


@dataclasses.dataclass
class KMeansCodebook(_Codebook):
    """K-Means vocabulary: cluster centers only (hard assignment).

    centers: (K, D)
    """

    centers: torch.Tensor

    @property
    def n_clusters(self) -> int:
        return self.centers.shape[0]

    @property
    def n_features_in(self) -> int:
        return self.centers.shape[1]

    @classmethod
    def from_sklearn(cls, kmeans: Any) -> "KMeansCodebook":
        return cls(centers=np.asarray(kmeans.cluster_centers_, np.float32))

    def to_sklearn(self):
        """An equivalent fitted sklearn ``KMeans``."""
        from sklearn.cluster import KMeans

        km = KMeans(n_clusters=self.n_clusters, n_init=1)
        km.cluster_centers_ = self.centers.cpu().numpy().astype(np.float32)
        km._n_features_out = self.n_clusters
        km.n_features_in_ = self.n_features_in
        km._n_threads = 1
        km.labels_ = np.zeros(self.n_clusters, np.int32)
        km.inertia_ = 0.0
        km.n_iter_ = 0
        return km


@dataclasses.dataclass
class GmmCodebook(_Codebook):
    """Diagonal-covariance Gaussian mixture vocabulary (a data holder until
    the Fisher-vector port).

    weights: (K,), means: (K, D), covariances: (K, D)
    """

    weights: torch.Tensor
    means: torch.Tensor
    covariances: torch.Tensor

    @property
    def n_components(self) -> int:
        return self.means.shape[0]

    @property
    def n_features_in(self) -> int:
        return self.means.shape[1]

    @classmethod
    def from_sklearn(cls, gmm: Any) -> "GmmCodebook":
        if getattr(gmm, "covariance_type", "diag") != "diag":
            raise ValueError(
                "Only diag-covariance GMMs are supported "
                f"(got covariance_type={gmm.covariance_type!r})."
            )
        return cls(
            weights=np.asarray(gmm.weights_, np.float32),
            means=np.asarray(gmm.means_, np.float32),
            covariances=np.asarray(gmm.covariances_, np.float32),
        )

    def to_sklearn(self):
        """An equivalent fitted sklearn diag ``GaussianMixture``."""
        from sklearn.mixture import GaussianMixture

        gmm = GaussianMixture(n_components=self.n_components, covariance_type="diag")
        gmm.weights_ = self.weights.cpu().numpy().astype(np.float64)
        gmm.means_ = self.means.cpu().numpy().astype(np.float64)
        gmm.covariances_ = self.covariances.cpu().numpy().astype(np.float64)
        gmm.precisions_cholesky_ = 1.0 / np.sqrt(gmm.covariances_)
        gmm.precisions_ = 1.0 / gmm.covariances_
        gmm.converged_ = True
        gmm.n_iter_ = 0
        gmm.lower_bound_ = 0.0
        gmm.n_features_in_ = self.n_features_in
        return gmm


def validate_codebook(codebook: Any) -> None:
    """Check the structural invariants of a vocabulary; raises ``ValueError``
    (``TypeError`` for a non-codebook)."""

    def _finite(name, arr, ndim):
        arr = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr)
        if arr.ndim != ndim:
            raise ValueError(f"{name}: expected {ndim}-D, got shape {arr.shape}")
        if not np.isfinite(arr).all():
            raise ValueError(f"{name}: contains non-finite values")
        return arr

    if isinstance(codebook, KMeansCodebook):
        centers = _finite("KMeansCodebook.centers", codebook.centers, 2)
        if centers.shape[0] < 1:
            raise ValueError("KMeansCodebook: needs at least one center")
    elif isinstance(codebook, GmmCodebook):
        w = _finite("GmmCodebook.weights", codebook.weights, 1)
        mu = _finite("GmmCodebook.means", codebook.means, 2)
        cov = _finite("GmmCodebook.covariances", codebook.covariances, 2)
        if not (w.shape[0] == mu.shape[0] == cov.shape[0]):
            raise ValueError(
                f"GmmCodebook: component counts disagree "
                f"(weights {w.shape}, means {mu.shape}, covariances {cov.shape})"
            )
        if mu.shape != cov.shape:
            raise ValueError(f"GmmCodebook: means {mu.shape} vs covariances {cov.shape}")
        if (w < 0).any() or abs(float(w.sum()) - 1.0) > 1e-3:
            raise ValueError(
                f"GmmCodebook: weights must be >= 0 and sum to 1 (sum={float(w.sum())!r})"
            )
        if (cov <= 0).any():
            raise ValueError("GmmCodebook: covariances must be strictly positive")
    elif isinstance(codebook, PcaProjector):
        comp = _finite("PcaProjector.components", codebook.components, 2)
        mean = _finite("PcaProjector.mean", codebook.mean, 1)
        if comp.shape[0] > comp.shape[1]:
            raise ValueError(f"PcaProjector: more components than input dims {comp.shape}")
        if mean.shape[0] != comp.shape[1]:
            raise ValueError(
                f"PcaProjector: mean dim {mean.shape[0]} != input dim {comp.shape[1]}"
            )
        if codebook.explained_variance is not None:
            ev = _finite("PcaProjector.explained_variance", codebook.explained_variance, 1)
            if (ev < 0).any():
                raise ValueError("PcaProjector: explained_variance must be >= 0")
    else:
        raise TypeError(f"Not a codebook: {type(codebook)}")


_KIND_TO_CLS = {"kmeans": KMeansCodebook, "gmm": GmmCodebook, "pca": PcaProjector}
_CLS_TO_KIND = {v: k for k, v in _KIND_TO_CLS.items()}


def save_codebook(path, codebook) -> None:
    """Write a codebook to ``.npz``: one array per field, ``__kind__``, and
    bool fields as 0-d arrays under a ``__bool__`` prefix."""
    kind = _CLS_TO_KIND.get(type(codebook))
    if kind is None:
        raise TypeError(f"Not a known codebook type: {type(codebook)}")
    arrays = {}
    for f in dataclasses.fields(codebook):
        v = getattr(codebook, f.name)
        if v is None:
            continue
        if isinstance(v, bool):
            arrays[f"__bool__{f.name}"] = np.asarray(v)
        else:
            arrays[f.name] = v.cpu().numpy()
    np.savez(path, __kind__=np.array(kind), **arrays)


def load_codebook(path):
    """Load a codebook saved by :func:`save_codebook` (or by the JAX
    package's), as CPU tensors."""
    with np.load(path, allow_pickle=False) as data:
        cls = _KIND_TO_CLS[str(data["__kind__"])]
        kwargs = {}
        for k in data.files:
            if k.startswith("__bool__"):
                kwargs[k[len("__bool__"):]] = bool(data[k])
            elif not k.startswith("__"):
                kwargs[k] = data[k]
    return cls(**kwargs)
