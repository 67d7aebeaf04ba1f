"""Retrieval evaluation: top-k retrieval, mAP, top-k accuracy.

Port of ``pyvisim_tpu/eval.py``: batched query encoding, one cosine
matmul on ``device`` (None means CUDA), and a vectorised AP.

Semantics kept:
  * ``top_k_map`` computes AP with R = number of relevant items within
    the considered (possibly k-truncated) ranking.
  * Ranking ties resolve by gallery order (numpy stable argsort on -sims).
"""
from __future__ import annotations

import os
from typing import Iterable

import numpy as np

from ._utils import cosine_similarity

__all__ = ["retrieve_top_k_similar", "top_k_map", "top_k_accuracy", "average_precision"]


def _bucket_size(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped."""
    b = 1
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


def _encode_queries(encoder, images, batch_size: int = 64) -> np.ndarray:
    """Encode query images in batches -> (Q, D).

    The trailing partial chunk is padded (by repeating its last image) up
    to a power-of-two size and the padding rows are dropped, so a ragged
    tail reuses one of log2(batch_size) batch shapes, as in the JAX
    package."""
    if isinstance(images, np.ndarray) and images.ndim == 3:
        images = [images]
    images = list(images)
    chunks = []
    for i in range(0, len(images), batch_size):
        block = images[i : i + batch_size]
        bucket = _bucket_size(len(block), batch_size)
        padded = block + [block[-1]] * (bucket - len(block))
        enc = np.asarray(encoder.encode(padded))
        if enc.ndim == 1:  # single-image encoders may return (D,)
            enc = enc.reshape(1, -1)
        chunks.append(enc[: len(block)])
    q = np.vstack(chunks)
    return q.reshape(1, -1) if q.ndim == 1 else q


def _gallery(encoding_map):
    """(paths, (N, D) vectors) from a ``{path: vector}`` dict or the path of
    an HDF5 gallery with flat ``vectors`` / ``paths`` datasets."""
    if isinstance(encoding_map, (str, bytes, os.PathLike)):
        import h5py

        with h5py.File(encoding_map, "r") as f:
            vectors = np.asarray(f["vectors"])
            paths = [
                p.decode() if isinstance(p, bytes) else str(p)
                for p in f["paths"][()]
            ]
        return paths, vectors
    paths = list(encoding_map.keys())
    vectors = np.array([np.asarray(encoding_map[p]).ravel() for p in paths])
    return paths, vectors


def retrieve_top_k_similar(
    uploaded_image: np.ndarray,
    dataset: dict[str, np.ndarray],
    encoder,
    k: int = 5,
    device=None,
) -> list[tuple[str, float]]:
    """Top-k most similar gallery images to a query image.

    :return: list of (image_path, similarity_score), descending.
    """
    all_paths, all_vectors = _gallery(dataset)
    query_vector = _encode_queries(encoder, uploaded_image)
    scores = cosine_similarity(query_vector, all_vectors, device=device)[0]
    top_k_indices = np.argsort(-scores)[:k]
    return [(all_paths[i], scores[i]) for i in top_k_indices]


def _ranked_relevance(
    query_vecs: np.ndarray,
    gallery_vecs: np.ndarray,
    gallery_labels: np.ndarray,
    query_labels: np.ndarray,
    k: int | None,
    device=None,
) -> np.ndarray:
    """(Q, N_considered) boolean relevance in ranked order."""
    sims = cosine_similarity(query_vecs, gallery_vecs, device=device)  # (Q, N)
    order = np.argsort(-sims, axis=1, kind="stable")
    if k is not None:
        order = order[:, :k]
    ranked_labels = gallery_labels[order]  # (Q, N')
    return ranked_labels == query_labels[:, None]


def average_precision(rel: np.ndarray) -> np.ndarray:
    """Vectorised AP per row of a ranked boolean relevance matrix, with
    R = relevant count within the considered ranking."""
    rel = rel.astype(np.float64)
    cum = np.cumsum(rel, axis=1)
    ranks = np.arange(1, rel.shape[1] + 1, dtype=np.float64)
    precision_sum = np.sum(cum / ranks[None, :] * rel, axis=1)
    r = rel.sum(axis=1)
    return np.where(r > 0, precision_sum / np.maximum(r, 1.0), 0.0)


def top_k_map(
    images: Iterable[np.ndarray],
    image_labels: Iterable[int],
    encoding_map: dict[str, np.ndarray],
    path_labels_dict: dict[str, int],
    encoder,
    k: int | None = None,
    batch_size: int = 64,
    device=None,
) -> float:
    """Mean Average Precision over queries."""
    all_paths, all_vectors = _gallery(encoding_map)
    gallery_labels = np.array([path_labels_dict[p] for p in all_paths])
    query_labels = np.array(list(image_labels))
    query_vecs = _encode_queries(encoder, images, batch_size)
    rel = _ranked_relevance(query_vecs, all_vectors, gallery_labels, query_labels, k, device)
    return float(np.mean(average_precision(rel)))


def top_k_accuracy(
    images: Iterable[np.ndarray],
    image_labels: Iterable[int],
    encoding_map: dict[str, np.ndarray],
    path_labels_dict: dict[str, int],
    encoder,
    k: int,
    batch_size: int = 64,
    device=None,
) -> float:
    """Fraction of queries with >= 1 same-label hit in the top k."""
    all_paths, all_vectors = _gallery(encoding_map)
    gallery_labels = np.array([path_labels_dict[p] for p in all_paths])
    query_labels = np.array(list(image_labels))
    query_vecs = _encode_queries(encoder, images, batch_size)
    rel = _ranked_relevance(query_vecs, all_vectors, gallery_labels, query_labels, k, device)
    return float(np.mean(rel.any(axis=1)))
