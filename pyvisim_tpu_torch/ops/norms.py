"""Normalisation primitives shared by the encoder cores.

Port of ``pyvisim_tpu/ops/norms.py``: signed power normalisation followed
by an L_p norm with an *additive* epsilon in the denominator.
"""
from __future__ import annotations

import math

import torch

__all__ = ["power_normalize", "lp_norm", "lp_normalize"]


def power_normalize(x: torch.Tensor, power: float) -> torch.Tensor:
    """Signed power normalisation ``sign(x) * |x| ** power``; ``power == 1``
    is the identity."""
    if power == 1.0:
        return x
    if power == 0.5:
        return torch.sign(x) * torch.sqrt(torch.abs(x))
    return torch.sign(x) * torch.abs(x) ** power


def lp_norm(x: torch.Tensor, ord: float = 2.0, dim: int = -1, keepdim: bool = True):
    """Vector L_p norm along ``dim`` (``np.linalg.norm`` vector semantics)."""
    if ord == 2.0:
        return torch.sqrt((x * x).sum(dim=dim, keepdim=keepdim))
    if ord == 1.0:
        return torch.abs(x).sum(dim=dim, keepdim=keepdim)
    if ord == math.inf:
        return torch.abs(x).amax(dim=dim, keepdim=keepdim)
    return (torch.abs(x) ** ord).sum(dim=dim, keepdim=keepdim) ** (1.0 / ord)


def lp_normalize(
    x: torch.Tensor, ord: float = 2.0, dim: int = -1, epsilon: float = 1e-9
) -> torch.Tensor:
    """Divide by ``lp_norm(x) + epsilon``.

    The epsilon is added to the norm, never a clamp: an all-zero row maps
    to an all-zero row, as in the reference encoders.
    """
    return x / (lp_norm(x, ord=ord, dim=dim, keepdim=True) + epsilon)
