"""Descriptor -> codebook assignment (the "predict" half of sklearn).

Port of ``pyvisim_tpu/ops/assign.py``: nearest centroid in matmul form.
The diagonal-GMM posteriors (``gmm_log_prob``, ``gmm_posteriors``) come
with the Fisher-vector port.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_sqdist", "nearest_centroid"]


def pairwise_sqdist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances ``(..., N, K)`` between ``x (..., N, D)``
    and ``centers (K, D)``: ``||x||^2 - 2 x c^T + ||c||^2``.

    The cross term is one matmul; on the card it runs in full f32 unless
    the caller turned on ``torch.backends.cuda.matmul.allow_tf32``.
    """
    x2 = (x * x).sum(dim=-1, keepdim=True)
    c2 = (centers * centers).sum(dim=-1)
    return x2 - 2.0 * (x @ centers.T) + c2


def nearest_centroid(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Index of the nearest centroid per row, ``(..., N)`` int32.

    Equivalent to sklearn ``KMeans.predict``; ties go to the lower index
    (``torch.argmin`` returns the first minimum).
    """
    return torch.argmin(pairwise_sqdist(x, centers), dim=-1).to(torch.int32)
