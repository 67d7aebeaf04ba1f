"""Similarity kernels.

Port of ``pyvisim_tpu/ops/similarity.py``: an L2 row normalisation and
one matmul. The JAX package's ``pad_rows_for_mxu`` pads tiny row sets to
fill the TPU's 8-row matrix tile; the card has no such tile, so it is not
ported.
"""
from __future__ import annotations

import torch

__all__ = ["cosine_similarity_matrix", "pairwise_euclidean"]


def _l2_normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Row L2 normalise; zero rows stay zero (sklearn ``normalize``)."""
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.where(norm == 0.0, torch.ones_like(norm), norm)


def cosine_similarity_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine similarity ``(N, M)`` between row sets ``x (N, D)`` and
    ``y (M, D)``; a zero row has similarity 0 to everything (sklearn
    ``cosine_similarity``)."""
    xn = _l2_normalize_rows(x.to(torch.float32))
    yn = _l2_normalize_rows(y.to(torch.float32))
    return xn @ yn.T


def pairwise_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix ``(N, M)`` in matmul form (clamped at 0)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    x2 = (x * x).sum(dim=-1, keepdim=True)
    y2 = (y * y).sum(dim=-1)
    return torch.sqrt(torch.clamp(x2 - 2.0 * (x @ y.T) + y2, min=0.0))
