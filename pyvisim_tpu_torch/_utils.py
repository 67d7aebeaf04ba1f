"""Utilities: cosine similarity on host arrays.

Port of the math half of ``pyvisim_tpu/_utils.py`` that the main path
uses (``cosine_similarity``, ``_to_numpy``); clustering evaluation,
persistence and plots come with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ._config import resolve_device
from .ops.similarity import cosine_similarity_matrix

__all__ = ["cosine_similarity"]


def cosine_similarity(x, y, device=None) -> np.ndarray:
    """Cosine similarity matrix between two batches of vectors, computed on
    ``device`` (``None`` means CUDA) and returned as numpy.

    1-D inputs are reshaped to (1, D); inputs with D <= 1 are rejected;
    numpy arrays and torch tensors are accepted.
    """
    x = _to_numpy(x)
    y = _to_numpy(y)
    x = x.reshape(1, -1) if x.ndim == 1 else x
    y = y.reshape(1, -1) if y.ndim == 1 else y
    if x.shape[-1] <= 1 or y.shape[-1] <= 1:
        raise ValueError(
            "cosine_similarity needs vectors with >= 2 features; received "
            f"feature dims x={x.shape[-1]}, y={y.shape[-1]}."
        )
    dev = resolve_device(device)
    sims = cosine_similarity_matrix(
        torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    )
    return sims.cpu().numpy()


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, np.ndarray):
        return a
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)
