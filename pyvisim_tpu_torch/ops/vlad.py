"""VLAD encoding core (Vector of Locally Aggregated Descriptors).

Port of ``pyvisim_tpu/ops/vlad.py``. The batch is an explicit leading
dimension: ``vlad_encode_batch`` sends all sets through
:func:`~pyvisim_tpu_torch.ops.cuda.aggregate.vlad_aggregate_batched` at
once, which on CUDA tensors is one kernel call for the whole batch.

Semantics kept:
  * residual accumulation ``sum_{n in cluster k} (x_n - c_k)``, weighted
    by the (float) mask;
  * signed power norm, default weight 1.0;
  * per-row (intra) L_p normalisation with additive epsilon;
  * optional flatten to ``(K*D,)``;
  * zero descriptors -> zero vector (a fully masked set aggregates to
    zeros, and the additive epsilon keeps it zero).

Descriptors are cast to float32 before aggregation.
"""
from __future__ import annotations

import torch

from .cuda.aggregate import vlad_aggregate_batched
from .norms import lp_normalize, power_normalize

__all__ = ["vlad_aggregate", "vlad_encode", "vlad_encode_batch"]


def _prepare(desc, mask, centers):
    desc = desc.to(torch.float32).contiguous()
    if mask is None:
        mask = torch.ones(desc.shape[:-1], dtype=torch.float32, device=desc.device)
    else:
        mask = mask.to(device=desc.device, dtype=torch.float32).contiguous()
    centers = centers.to(device=desc.device, dtype=torch.float32).contiguous()
    return desc, mask, centers


def _aggregate_batch(desc, mask, centers, chunk_size):
    """``(B, N, D)`` -> ``(B, K, D)``. With ``chunk_size`` the sets are cut
    into zero-weight-padded chunks that aggregate as one larger batch and
    are summed back: the aggregate is linear in the descriptor set."""
    b, n, d = desc.shape
    if chunk_size is None or chunk_size >= n:
        return vlad_aggregate_batched(desc, mask, centers)
    pad = (-n) % chunk_size
    if pad:
        desc = torch.nn.functional.pad(desc, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    n_chunks = desc.shape[1] // chunk_size
    v = vlad_aggregate_batched(
        desc.reshape(b * n_chunks, chunk_size, d).contiguous(),
        mask.reshape(b * n_chunks, chunk_size).contiguous(),
        centers,
    )
    return v.reshape(b, n_chunks, *v.shape[1:]).sum(dim=1)


def vlad_aggregate(
    desc: torch.Tensor,
    mask: torch.Tensor | None,
    centers: torch.Tensor,
    *,
    chunk_size: int | None = None,
) -> torch.Tensor:
    """Unnormalised VLAD matrix ``(K, D)`` of summed residuals of one set
    ``desc (N, D)``: ``V[k] = sum_{n: a_n = k} m_n (x_n - c_k)``."""
    desc, mask, centers = _prepare(desc, mask, centers)
    return _aggregate_batch(desc[None], mask[None], centers, chunk_size)[0]


def vlad_encode_batch(
    desc: torch.Tensor,
    mask: torch.Tensor | None,
    centers: torch.Tensor,
    *,
    power_norm_weight: float = 1.0,
    norm_order: float = 2.0,
    epsilon: float = 1e-9,
    flatten: bool = True,
    chunk_size: int | None = None,
) -> torch.Tensor:
    """VLAD over a batch: ``desc (B, N, D)``, ``mask (B, N)`` ->
    ``(B, K*D)`` (or ``(B, K, D)`` when ``flatten=False``). Defaults mirror
    the reference's VLADEncoder (power 1.0, L2, eps 1e-9)."""
    desc, mask, centers = _prepare(desc, mask, centers)
    v = _aggregate_batch(desc, mask, centers, chunk_size)
    v = power_normalize(v, power_norm_weight)
    v = lp_normalize(v, ord=norm_order, dim=-1, epsilon=epsilon)
    return v.reshape(v.shape[0], -1) if flatten else v


def vlad_encode(
    desc: torch.Tensor,
    mask: torch.Tensor | None,
    centers: torch.Tensor,
    **kwargs,
) -> torch.Tensor:
    """Full VLAD encoding of one set: ``(K*D,)`` if ``flatten`` else
    ``(K, D)``; keyword arguments as :func:`vlad_encode_batch`."""
    if mask is not None:
        mask = mask[None]
    return vlad_encode_batch(desc[None], mask, centers, **kwargs)[0]
