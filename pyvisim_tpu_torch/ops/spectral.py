"""Spectral clustering on the device.

Port of ``pyvisim_tpu/ops/spectral.py``, the replacement for sklearn's
``SpectralClustering(affinity='nearest_neighbors')`` in the clustering
evaluation: a dense (N, N) kNN connectivity graph, the symmetrically
normalised Laplacian, its ``eigh`` embedding rescaled by D^{-1/2} as
sklearn rescales it, then K-Means on the embedding. Distances and ``eigh``
run in full float32 (TF32 off), as JAX pins them.
"""
from __future__ import annotations

import torch

from .._config import full_f32, resolve_device
from .assign import nearest_centroid, pairwise_sqdist
from .kmeans import kmeans_fit

__all__ = ["spectral_embedding", "spectral_cluster", "knn_affinity"]


def knn_affinity(x: torch.Tensor, n_neighbors: int = 10) -> torch.Tensor:
    """Symmetrised kNN connectivity matrix ``0.5 * (A + A^T)``, (N, N), of
    the rows of ``x (N, D)``, on ``x``'s device.

    ``A`` holds a 1 at the ``n_neighbors + 1`` smallest squared distances
    of each row (self included), taken in ``lax.top_k``'s order (a stable
    sort: the lower index first among equal distances), and a 1 on the
    diagonal even where a duplicate row pushed self out of them.
    """
    n = x.shape[0]
    with full_f32():
        d2 = pairwise_sqdist(x, x)
    idx = torch.sort(-d2, dim=1, descending=True, stable=True).indices[:, : n_neighbors + 1]
    a = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    a.scatter_(1, idx, 1.0)
    a.diagonal().fill_(1.0)
    return 0.5 * (a + a.T)


def spectral_embedding(
    x: torch.Tensor, n_components: int, n_neighbors: int = 10
) -> torch.Tensor:
    """(N, n_components) spectral embedding of the rows of ``x (N, D)``
    from the normalised Laplacian of :func:`knn_affinity`, on ``x``'s
    device: the eigenvectors of the smallest eigenvalues, times D^{-1/2},
    each column's entry of largest magnitude (the first of them) made
    positive."""
    w = knn_affinity(x, n_neighbors)
    deg = w.sum(dim=1)
    d_inv_sqrt = 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12))
    l_sym = -(w * d_inv_sqrt[:, None] * d_inv_sqrt[None, :])
    l_sym.diagonal().add_(1.0)
    with full_f32():
        _, eigvecs = torch.linalg.eigh(l_sym)  # ascending
    emb = eigvecs[:, :n_components] * d_inv_sqrt[:, None]
    cols = torch.arange(n_components, device=x.device)
    signs = torch.sign(emb[torch.argmax(emb.abs(), dim=0), cols])
    return emb * torch.where(signs == 0, 1.0, signs)[None, :]


def spectral_cluster(
    x,
    n_clusters: int,
    *,
    n_neighbors: int = 10,
    seed: int = 42,
    n_init: int = 3,
    device=None,
) -> torch.Tensor:
    """Cluster the rows of ``x (N, D)`` -> int32 labels ``(N,)``, on
    ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
    emb = spectral_embedding(x, n_clusters, n_neighbors)
    cb, _ = kmeans_fit(emb, n_clusters, seed=seed, n_init=n_init, device=dev)
    return nearest_centroid(emb, cb.centers)
