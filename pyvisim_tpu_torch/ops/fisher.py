"""Fisher Vector encoding core.

Port of ``pyvisim_tpu/ops/fisher.py``. The batch is an explicit leading
dimension: ``fisher_encode_batch`` sends all sets through
:func:`~pyvisim_tpu_torch.ops.cuda.gmm_stats.gmm_stats_batched` at once,
which on CUDA tensors is one kernel call for the whole batch (the JAX
package vmaps one set at a time).

Semantics kept:
  * ``pp_sum``, ``pp_x = q^T x``, ``pp_x_2 = q^T x^2``, each divided by the
    number of *valid* descriptors (at least 1);
  * ``d_pi = pp_sum - w``, ``d_mu = pp_x - pp_sum * mu`` and the
    reference's **sign-flipped** ``d_sigma = -pp_x_2 - pp_sum*mu^2 +
    pp_sum*cov + 2*pp_x*mu``, normalised by ``sqrt(w)``,
    ``sqrt(w)*sqrt(cov)`` and ``sqrt(2w)*cov``;
  * concat order ``[d_pi, d_mu.ravel(), d_sigma.ravel()]``;
  * signed power norm (default 0.5), then a global L_p norm with additive
    epsilon.

Output dim: ``2*K*D + K``. Descriptors are cast to float32.
"""
from __future__ import annotations

import math

import torch

from .codebooks import GmmCodebook
from .cuda.gmm_stats import gmm_stats_batched
from .norms import lp_normalize, power_normalize

__all__ = ["fisher_stats", "fisher_encode", "fisher_encode_batch"]


def _prepare(desc, mask, gmm):
    desc = desc.to(torch.float32).contiguous()
    if mask is None:
        mask = torch.ones(desc.shape[:-1], dtype=torch.float32, device=desc.device)
    else:
        mask = mask.to(device=desc.device, dtype=torch.float32).contiguous()
    params = tuple(
        t.to(device=desc.device, dtype=torch.float32).contiguous()
        for t in (gmm.weights, gmm.means, gmm.covariances)
    )
    return desc, mask, params


def gmm_stats_chunked(desc, mask, params, chunk_size=None, *, with_ll=False):
    """Unnormalised statistics of ``(B, N, D)`` sets; with ``chunk_size``
    the rows go through in slices of that many, summed, so that the
    ``(B, chunk, K)`` posterior block bounds memory."""
    n = desc.shape[1]
    if chunk_size is None or chunk_size >= n:
        return gmm_stats_batched(desc, mask, *params, with_ll=with_ll)
    total = None
    for start in range(0, n, chunk_size):
        part = gmm_stats_batched(
            desc[:, start : start + chunk_size].contiguous(),
            mask[:, start : start + chunk_size].contiguous(),
            *params, with_ll=with_ll,
        )
        total = part if total is None else tuple(a + b for a, b in zip(total, part))
    return total


def _normalised_stats(desc, mask, params, chunk_size):
    s0, s1, s2 = gmm_stats_chunked(desc, mask, params, chunk_size)
    n_valid = mask.sum(dim=1).clamp_min(1.0)
    return s0 / n_valid[:, None], s1 / n_valid[:, None, None], s2 / n_valid[:, None, None]


def fisher_stats(
    desc: torch.Tensor,
    mask: torch.Tensor | None,
    gmm: GmmCodebook,
    *,
    chunk_size: int | None = None,
):
    """Sufficient statistics ``(pp_sum (K,), pp_x (K, D), pp_x_2 (K, D))`` of
    one set ``desc (N, D)``, normalised by the number of valid descriptors;
    masked rows carry no posterior mass."""
    desc, mask, params = _prepare(desc, mask, gmm)
    s0, s1, s2 = _normalised_stats(desc[None], mask[None], params, chunk_size)
    return s0[0], s1[0], s2[0]


def fisher_encode_batch(
    desc: torch.Tensor,
    mask: torch.Tensor | None,
    gmm: GmmCodebook,
    *,
    power_norm_weight: float = 0.5,
    norm_order: float = 2.0,
    epsilon: float = 1e-9,
    flatten: bool = True,
    chunk_size: int | None = None,
) -> torch.Tensor:
    """Fisher Vectors of a batch: ``desc (B, N, D)``, ``mask (B, N)`` ->
    ``(B, 2*K*D + K)``, or ``(B, 1, 2*K*D + K)`` when ``flatten=False`` (the
    reference's un-flattened row vector per image). Defaults mirror the
    reference's FisherVectorEncoder (power 0.5, L2, eps 1e-9)."""
    desc, mask, params = _prepare(desc, mask, gmm)
    w, mu, cov = params
    pp_sum, pp_x, pp_x_2 = _normalised_stats(desc, mask, params, chunk_size)
    s = pp_sum[..., None]

    d_pi = pp_sum - w
    d_mu = pp_x - s * mu
    d_sigma = -pp_x_2 - s * mu**2 + s * cov + 2.0 * pp_x * mu

    sqrt_w = torch.sqrt(w)
    d_pi = d_pi / sqrt_w
    d_mu = d_mu / (sqrt_w[:, None] * torch.sqrt(cov))
    d_sigma = d_sigma / (math.sqrt(2.0) * sqrt_w[:, None] * cov)

    b = desc.shape[0]
    v = torch.cat([d_pi, d_mu.reshape(b, -1), d_sigma.reshape(b, -1)], dim=1)
    v = power_normalize(v, power_norm_weight)
    v = lp_normalize(v, ord=norm_order, dim=-1, epsilon=epsilon)
    return v if flatten else v[:, None, :]


def fisher_encode(
    desc: torch.Tensor,
    mask: torch.Tensor | None,
    gmm: GmmCodebook,
    **kwargs,
) -> torch.Tensor:
    """Fisher Vector of one set: ``(2*K*D + K,)``, or ``(1, 2*K*D + K)``
    when ``flatten=False``; keyword arguments as
    :func:`fisher_encode_batch`."""
    if mask is not None:
        mask = mask[None]
    return fisher_encode_batch(desc[None], mask, gmm, **kwargs)[0]
