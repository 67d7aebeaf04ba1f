"""Descriptor -> codebook assignment (the "predict" half of sklearn).

Port of ``pyvisim_tpu/ops/assign.py``: nearest centroid and diagonal-GMM
log-densities and posteriors, each in matmul form.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_sqdist", "nearest_centroid", "gmm_terms", "gmm_log_prob", "gmm_posteriors"]

_LOG_2PI = 1.8378770664093453  # log(2*pi)


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


def gmm_terms(weights: torch.Tensor, means: torch.Tensor, covariances: torch.Tensor):
    """The diag-GMM log density in matmul form: ``log w_k + log N(x | mu_k,
    diag sigma_k) = x @ minv^T - x^2 @ half_inv^T + const_k``, with
    ``minv = mu / sigma``, ``half_inv = 0.5 / sigma`` (K, D) and
    ``const = log w - 0.5 (D log 2pi + sum log sigma + sum mu^2 / sigma)``
    (K,), ``sigma`` being the covariances."""
    inv_cov = 1.0 / covariances
    minv = means * inv_cov
    const = torch.log(weights) - 0.5 * (
        means.shape[-1] * _LOG_2PI
        + torch.log(covariances).sum(dim=-1)
        + (means * minv).sum(dim=-1)
    )
    return minv, 0.5 * inv_cov, const


def gmm_log_prob(x: torch.Tensor, gmm) -> torch.Tensor:
    """Per-component weighted log density ``log w_k + log N(x | mu_k, diag
    sigma_k)``, ``(..., N, K)`` for ``x (..., N, D)``: two matmuls (see
    :func:`gmm_terms`), in full f32 unless the caller turned on TF32.
    """
    minv, half_inv, const = gmm_terms(gmm.weights, gmm.means, gmm.covariances)
    return x @ minv.T - (x * x) @ half_inv.T + const


def gmm_posteriors(x: torch.Tensor, gmm) -> torch.Tensor:
    """Posterior responsibilities ``q_nk``: the softmax of
    :func:`gmm_log_prob` over components (sklearn ``predict_proba``)."""
    return torch.softmax(gmm_log_prob(x, gmm), dim=-1)
