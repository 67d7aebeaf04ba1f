"""Abstract contracts for similarity metrics and feature extractors.

Port of ``pyvisim_tpu/_base_classes.py``: extractors emit fixed-budget
``(B, N_max, D)`` descriptor batches plus validity masks.
"""
from __future__ import annotations

import abc
from typing import Any, Iterable, Tuple

import numpy as np

from ._config import get_logger
from ._validation import validate_image


class SimilarityMetric(abc.ABC):
    """Abstract base for all similarity encoders."""

    _logger = get_logger("similarity_metric")

    @abc.abstractmethod
    def similarity_score(self, images1, images2):
        """Compute a similarity score (or matrix) between two image batches."""
        raise NotImplementedError


class FeatureExtractorBase(abc.ABC):
    """Abstract interface for extracting local features from images.

    ``__call__(image) -> (N, output_dim)`` float32 numpy array for a single
    HWC numpy image. ``extract_batch(images) -> (desc, mask)`` with
    ``desc (B, N_max, output_dim)`` and ``mask (B, N_max)``; the default
    loops ``__call__`` on the host and pads, subclasses override it with a
    batched device path.
    """

    _logger = get_logger("feature_extractor")

    def __init__(self):
        pass

    @abc.abstractmethod
    def __call__(self, image: np.ndarray) -> np.ndarray:
        """Extract features from one image; validates the input image."""
        validate_image(image, 0)

    @property
    @abc.abstractmethod
    def output_dim(self) -> int:
        """Dimensionality D of each feature vector (shape[1] of the output)."""
        raise NotImplementedError

    @property
    def descriptor_budget(self) -> int | None:
        """Static N_max for the batched path; None = dynamic (host loop only)."""
        return None

    def extract_batch(
        self, images: Iterable[np.ndarray] | np.ndarray
    ) -> Tuple[Any, Any]:
        """Host-side fallback: loop ``__call__``, pad to a common N, mask."""
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        all_desc = [np.asarray(self(img), np.float32) for img in images]
        if not all_desc:
            raise ValueError("extract_batch received no images.")
        budget = self.descriptor_budget
        n_max = max(max(d.shape[0] for d in all_desc), 1)
        if budget is not None:
            n_max = budget
        b = len(all_desc)
        desc = np.zeros((b, n_max, self.output_dim), np.float32)
        mask = np.zeros((b, n_max), np.float32)
        for i, d in enumerate(all_desc):
            n = min(d.shape[0], n_max)
            desc[i, :n] = d[:n]
            mask[i, :n] = 1.0
        return desc, mask
