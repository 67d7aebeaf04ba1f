"""The collectives of the mesh paths, each over one axis of a mesh.

Under NCCL the tensors stay on the card. Gloo takes CUDA tensors for only a
few collectives, so where an axis's group runs gloo (two ranks that share
one card, which NCCL refuses) a CUDA tensor is staged through pinned host
memory; the group's backend decides, never a failed attempt.
:func:`staged_bytes` counts the bytes so staged, each way.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "broadcast", "barrier", "staged_bytes",
           "reset_staged_bytes"]

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
_staged = [0]


def staged_bytes() -> int:
    """Bytes copied between the card and the host for gloo collectives since
    the last :func:`reset_staged_bytes`."""
    return _staged[0]


def reset_staged_bytes() -> None:
    _staged[0] = 0


def _staging(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    _staged[0] += host.nbytes
    return host


def _to_card(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    _staged[0] += host.nbytes
    return host.to(device)


def all_reduce(t: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", "min" or "max") of ``t`` over the ranks of ``axis``;
    returns a new tensor on ``t``'s device."""
    group = mesh.get_group(axis)
    if _staging(group, t):
        host = _to_host(t)
        dist.all_reduce(host, _OPS[op], group=group)
        return _to_card(host, t.device)
    out = t.contiguous().clone()
    dist.all_reduce(out, _OPS[op], group=group)
    return out


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' equal-shaped ``t`` concatenated along ``dim`` in their order
    along ``axis``."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if _staging(group, t):
        host = _to_host(t)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return _to_card(torch.cat(parts, dim=dim), t.device)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The first rank's ``t`` along ``axis``, on every rank of it."""
    group = mesh.get_group(axis)
    src = dist.get_global_rank(group, 0)
    if _staging(group, t):
        host = _to_host(t)
        dist.broadcast(host, src, group=group)
        return _to_card(host, t.device)
    out = t.contiguous().clone()
    dist.broadcast(out, src, group=group)
    return out


def barrier() -> None:
    """Wait for every rank of the world."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
