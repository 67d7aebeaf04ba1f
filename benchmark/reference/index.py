"""Plain exact search: cosine scores of queries against every gallery row,
each side normalised to unit length, in float64 (the reference) or in
bfloat16 (the control's precision), over blocks of rows."""
from __future__ import annotations

import torch

DTYPES = {"float64": torch.float64, "bfloat16": torch.bfloat16}


def _unit(x: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / torch.where(n == 0, torch.ones_like(n), n)


def scores(queries: torch.Tensor, rows: torch.Tensor, precision: str = "float64",
           block: int = 512) -> torch.Tensor:
    """``(Q, n)`` float64 cosine scores of ``queries (Q, D)`` against
    ``rows (n, D)``."""
    dt = DTYPES[precision]
    q = _unit(queries.to(dt))
    out = torch.empty((q.shape[0], rows.shape[0]), dtype=torch.float64, device=q.device)
    for s in range(0, rows.shape[0], block):
        out[:, s:s + block] = (q @ _unit(rows[s:s + block].to(dt)).T).to(torch.float64)
    return out
