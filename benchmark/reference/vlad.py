"""Plain VLAD: hard assignment to the nearest centre, residual sums,
signed power normalisation and per-cluster L2 normalisation with an
additive epsilon, flattened (the semantics of ``pyvisim``'s VLADEncoder
and of ``pyvisim_tpu_torch/ops/vlad.py``).

``float64`` is the reference: distances, sums and norms in float64, so it
stands above the float32 the configurations state. ``bfloat16`` is the
control's precision: descriptors, centres, distances, sums and norms
rounded to bfloat16.
"""
from __future__ import annotations

import torch

DTYPES = {"float64": torch.float64, "bfloat16": torch.bfloat16}


def encode(desc: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor, *,
           precision: str = "float64", power: float = 1.0, epsilon: float = 1e-9):
    """``desc (B, N, D)``, ``mask (B, N)`` weights, ``centers (K, D)`` ->
    ``(B, K * D)`` encodings in float64 and the ``(B, N)`` labels (-1 for
    rows of zero weight)."""
    dt = DTYPES[precision]
    x, c, m = desc.to(dt), centers.to(dt), mask.to(dt)
    d2 = (x * x).sum(-1, keepdim=True) - 2.0 * (x @ c.T) + (c * c).sum(-1)
    labels = d2.argmin(dim=-1)
    resid = (x - c[labels]) * m[..., None]
    b, k, d = x.shape[0], c.shape[0], c.shape[1]
    v = torch.zeros((b, k, d), dtype=dt, device=x.device)
    v.scatter_add_(1, labels[..., None].expand(-1, -1, d), resid)
    if power != 1.0:
        v = torch.sign(v) * v.abs() ** power
    v = v / (torch.sqrt((v * v).sum(-1, keepdim=True)) + epsilon)
    return v.reshape(b, k * d).to(torch.float64), torch.where(m > 0, labels, -1)


def nonempty_clusters(labels: torch.Tensor) -> int:
    """The number of clusters that hold at least one weighted row."""
    return int(torch.unique(labels[labels >= 0]).numel())
