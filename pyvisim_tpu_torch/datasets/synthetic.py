"""Synthetic multi-class image corpora for offline evaluation.

A copy of ``pyvisim_tpu/datasets/synthetic.py`` (numpy, and OpenCV for the
affine warp), kept in the port so that it imports nothing of the JAX
package; the same seed gives the same images and galleries bit for bit.
Each "class" is a procedurally generated base scene (a field of Gaussian
blobs) observed under mild affine jitter and sensor noise: enough texture
for SIFT-family extractors, and enough intra-class structure that
encodings carry realistic (non-i.i.d.) margin structure. The serving
index's recall is sized on galleries made with ``expand_encodings``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_class_images", "make_retrieval_corpus", "expand_encodings"]


def make_class_images(
    seed: int, n: int, h: int = 240, w: int = 300
) -> list[np.ndarray]:
    """``n`` RGB uint8 views of one procedurally generated scene class.

    One 'class' = a structured base scene (25 Gaussian blobs of varying
    scale/intensity) + per-view mild affine warp (±8° rotation, 0.92-1.08
    scale, ±8 px shift) and Gaussian sensor noise. Requires OpenCV for the
    affine warp.
    """
    import cv2

    rng = np.random.default_rng(seed)
    base = np.zeros((h, w), np.float32)
    for _ in range(25):
        y, x = rng.integers(30, h - 30), rng.integers(30, w - 30)
        s = rng.integers(3, 12)
        yy, xx = np.mgrid[-25:26, -25:26]
        base[y - 25 : y + 26, x - 25 : x + 26] += np.exp(
            -(yy**2 + xx**2) / (2 * s**2)
        ) * rng.uniform(60, 220)
    base = np.clip(base, 0, 255)
    images = []
    for _ in range(n):
        ang = rng.uniform(-8, 8)
        scale = rng.uniform(0.92, 1.08)
        m = cv2.getRotationMatrix2D((w / 2, h / 2), ang, scale)
        m[:, 2] += rng.uniform(-8, 8, size=2)
        img = cv2.warpAffine(base, m, (w, h))
        img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
        images.append(np.stack([img] * 3, axis=-1))
    return images


def make_retrieval_corpus(
    n_classes: int,
    n_per_class: int,
    *,
    seed: int = 100,
    h: int = 240,
    w: int = 300,
) -> tuple[list[np.ndarray], np.ndarray]:
    """``(images, labels)`` for ``n_classes`` scene classes, ``n_per_class``
    views each (labels are class indices in generation order)."""
    images: list[np.ndarray] = []
    labels: list[int] = []
    for cls in range(n_classes):
        images.extend(make_class_images(seed=seed + cls, n=n_per_class, h=h, w=w))
        labels.extend([cls] * n_per_class)
    return images, np.asarray(labels)


def expand_encodings(
    encodings: np.ndarray,
    labels: np.ndarray,
    n_total: int,
    *,
    seed: int = 0,
    noise: float = 0.02,
) -> tuple[np.ndarray, np.ndarray]:
    """Expand a small set of real encodings into a large gallery that keeps
    their margin structure.

    New rows are convex combinations of two same-class encodings plus a
    small isotropic perturbation, re-normalized — they live on the class
    manifolds of the real vectors (correlated dimensions, realistic
    inter/intra-class margins) instead of the i.i.d. distractor floor a
    random gallery has. Used to size serving-index ``rerank`` against
    realistic tie structure (docs/PERF.md "Serving-index recall").
    """
    encodings = np.asarray(encodings, np.float32)
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    rows = [encodings]
    out_labels = [labels]
    n_extra = n_total - encodings.shape[0]
    if n_extra > 0:
        cls_index = {c: np.flatnonzero(labels == c) for c in np.unique(labels)}
        pick_cls = rng.choice(np.unique(labels), size=n_extra)
        extra = np.empty((n_extra, encodings.shape[1]), np.float32)
        for i, c in enumerate(pick_cls):
            a, b = rng.choice(cls_index[c], size=2, replace=True)
            t = rng.uniform(0.0, 1.0)
            v = t * encodings[a] + (1.0 - t) * encodings[b]
            v = v + noise * rng.standard_normal(v.shape).astype(np.float32) * (
                np.linalg.norm(v) / np.sqrt(v.shape[0])
            )
            extra[i] = v
        rows.append(extra)
        out_labels.append(pick_cls)
    gal = np.concatenate(rows)
    gal = gal / np.maximum(np.linalg.norm(gal, axis=1, keepdims=True), 1e-12)
    return gal, np.concatenate(out_labels)[: gal.shape[0]]
