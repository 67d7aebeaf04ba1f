"""Multi-process runtime: joining a ``torch.distributed`` world, and meshes
that span hosts.

Port of ``pyvisim_tpu/parallel/distributed.py``:

1. every process calls :func:`init_distributed` once, before it builds a
   mesh (``torch.distributed.init_process_group`` with an explicit
   address, world size and rank, from arguments or the environment);
2. :func:`make_hybrid_mesh` builds a mesh whose leading (``data``) axis
   spans hosts while the other axes (``model`` / ``cluster``) stay inside a
   host, so their collectives stay on the host's own links.

A single-process run needs neither: :func:`init_distributed` returns False
and :func:`make_hybrid_mesh` collapses to a local mesh of the same logical
shape.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from .._config import get_logger, resolve_device
from .mesh import make_mesh

logger = get_logger(__name__)

__all__ = ["init_distributed", "plan_hybrid_mesh", "make_hybrid_mesh"]


def _env_int(*names: str) -> int | None:
    for name in names:
        val = os.environ.get(name)
        if val:
            return int(val)
    return None


def _torchrun_address() -> str | None:
    addr = os.environ.get("MASTER_ADDR")
    if not addr:
        return None
    return f"{addr}:{os.environ.get('MASTER_PORT', '29500')}"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
    *,
    backend: str | None = None,
    device=None,
) -> bool:
    """Join the multi-process world; a no-op for single-process runs.

    Arguments left out come from ``PYVISIM_COORDINATOR`` /
    ``PYVISIM_NUM_PROCESSES`` / ``PYVISIM_PROCESS_ID``, then from torchrun's
    ``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``. An explicit
    ``num_processes=1`` always means a single process, even with a
    coordinator address (stray) in the environment. Returns True when the
    process group was initialised, False for a single process.

    :param coordinator_address: ``host:port`` of rank 0's store.
    :param local_device_ids: the CUDA device of this process, as its first
        entry; default ``LOCAL_RANK`` (else the rank) modulo the cards of
        the host.
    :param backend: default NCCL on CUDA and gloo on the CPU.
    :param device: "cuda" (None) or "cpu"; CUDA raises without a card.
    """
    coordinator_address = (
        coordinator_address or os.environ.get("PYVISIM_COORDINATOR") or _torchrun_address()
    )
    if num_processes is None:
        num_processes = _env_int("PYVISIM_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PYVISIM_PROCESS_ID", "RANK")
    if num_processes == 1 or (coordinator_address is None and num_processes is None):
        logger.info("single-process run; skipping init_process_group")
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs a coordinator address, a process count and a process "
            f"id; got {coordinator_address!r}, {num_processes!r}, {process_id!r}"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = local_device_ids[0] if local_device_ids else _env_int("LOCAL_RANK")
        if index is None:
            index = process_id
        torch.cuda.set_device(index % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id,
    )
    logger.info("distributed runtime up: process %d/%d (%s)", process_id, num_processes,
                backend)
    return True


def plan_hybrid_mesh(
    n_processes: int,
    local_device_count: int,
    axis_names: tuple[str, ...] = ("data", "model"),
    within_host_shape: tuple[int, ...] | None = None,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Pure mesh-shape planning: ``(within_host_shape, across_hosts_shape)``
    per axis.

    Axis 0 (conventionally ``data``) is the only axis that crosses hosts:
    its extent across hosts is ``n_processes`` and it also takes any local
    devices left over after the within-host axes. Axes 1.. (``model`` /
    ``cluster``) must fit inside one host.

    :param within_host_shape: sizes of axes 1..; defaults to all remaining
        local devices on axis 1 (or nothing when there is only one axis).
    :raises ValueError: when the within-host axes don't divide the local
        device count.
    """
    n_within_axes = len(axis_names) - 1
    if within_host_shape is None:
        within_host_shape = (
            () if n_within_axes == 0 else (local_device_count,) + (1,) * (n_within_axes - 1)
        )
    if len(within_host_shape) != n_within_axes:
        raise ValueError(
            f"within_host_shape {within_host_shape} must size axes {axis_names[1:]}"
        )
    within_total = math.prod(within_host_shape) if within_host_shape else 1
    if local_device_count % within_total != 0:
        raise ValueError(
            f"within-host axes {dict(zip(axis_names[1:], within_host_shape))} "
            f"need {within_total} chips but each host has {local_device_count}"
        )
    local_data = local_device_count // within_total
    ici_shape = (local_data, *within_host_shape)
    dcn_shape = (n_processes,) + (1,) * n_within_axes
    return ici_shape, dcn_shape


def make_hybrid_mesh(
    axis_names: tuple[str, ...] = ("data", "model"),
    within_host_shape: tuple[int, ...] | None = None,
    devices=None,
    device_type: str = "cuda",
):
    """A mesh whose ``data`` axis spans hosts (and leftover local ranks)
    while the remaining axes stay within each host.

    Ranks are laid out host-major: with ``LOCAL_WORLD_SIZE`` ranks on each
    host (as torchrun sets it; else the whole world on one host), host
    ``h`` holds the consecutive ranks from ``h * LOCAL_WORLD_SIZE`` and its
    block of the ``data`` axis. A single-process run collapses to a
    local mesh of the same logical shape.

    :param devices: as :func:`~.mesh.make_mesh`: an order of the world's
        ranks (host-major).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks_per_host = _env_int("LOCAL_WORLD_SIZE") or world
    if world % ranks_per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {ranks_per_host}")
    n_hosts = world // ranks_per_host
    ici_shape, dcn_shape = plan_hybrid_mesh(n_hosts, ranks_per_host, axis_names,
                                            within_host_shape)
    shape = tuple(i * d for i, d in zip(ici_shape, dcn_shape))
    return make_mesh(world, axis_names, shape, devices=devices, device_type=device_type)
