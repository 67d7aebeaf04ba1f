"""Device meshes over the ranks of a ``torch.distributed`` world.

Port of ``pyvisim_tpu/parallel/mesh.py``. JAX runs a mesh from one
controller process; here every rank of the world is its own process, and a
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over all of
them, with JAX's axis names:

  * ``data``    - image batch / descriptor rows (data parallel)
  * ``cluster`` - the K centroid/component axis of VLAD/FV vocabularies
  * ``model``   - the output rows of the Siamese head's dense layers

Each axis's collectives run on ``mesh.get_group(axis)``. Every rank calls a
function with the same global inputs, as JAX's controller passes the global
array; a tensor sharded over an axis is cut into contiguous blocks, block
``i`` on the rank at position ``i`` of that axis, which is the block JAX's
``NamedSharding`` gives that device. ``P`` and ``NamedSharding`` are small
records of that layout.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "data_sharding", "replicated", "P", "NamedSharding"]


def _world_of_one(device_type: str) -> None:
    """A default process group of this process alone, for a mesh built
    without ``init_distributed``."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: the CPU, or its current CUDA card."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, ...] = ("data",),
    shape: tuple[int, ...] | None = None,
    devices=None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """Build a named mesh over every rank of the world.

    :param n_devices: number of ranks (default: the world size). Unlike
        JAX, which can take the first ``n`` devices of one controller, a
        rank left outside the mesh would have nothing to run, so any other
        count raises ``ValueError``.
    :param axis_names: mesh axis names, e.g. ("data",) or ("data", "model").
    :param shape: explicit per-axis sizes; default puts every rank on the
        first axis.
    :param devices: optional order of the global ranks laid out row-major
        over ``shape`` (default ``0 .. world - 1``).
    :param device_type: "cuda" (the default; raises without a card) or
        "cpu". Without a process group, a world of this process alone is
        started (NCCL for CUDA, gloo for the CPU).
    """
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device_type='cuda') needs a CUDA device and none is available; "
            "pass device_type='cpu' to run on the CPU."
        )
    if not dist.is_initialized():
        _world_of_one(device_type)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"devices {ranks} must order the world's {world} ranks")
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(
            f"a mesh spans the whole world: n_devices={n_devices} but the world has "
            f"{world} ranks"
        )
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name axes {axis_names}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    layout = torch.tensor(ranks, dtype=torch.int).reshape(shape)
    return DeviceMesh(device_type, layout, mesh_dim_names=tuple(axis_names))


def axis_names(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` (JAX: ``mesh.shape[axis]``)."""
    return mesh.size(axis_names(mesh).index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along ``axis`` (JAX: ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


class P(tuple):
    """A partition spec: one mesh axis name, or None, per tensor dimension
    (dimensions past its length are replicated), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and a partition spec: which block of a global tensor each rank
    holds."""

    mesh: DeviceMesh
    spec: P

    def placements(self):
        """The DTensor placements (one per mesh axis) of this layout."""
        from torch.distributed.tensor import Replicate, Shard

        names = axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                out[names.index(axis)] = Shard(dim)
        return tuple(out)

    def local_slices(self, shape) -> tuple[slice, ...]:
        """This rank's block of a tensor of the global ``shape``, as DTensor
        lays out :meth:`placements`; each sharded dimension must divide by
        its axis's size."""
        out = [slice(None)] * len(shape)
        for axis, placement in zip(axis_names(self.mesh), self.placements()):
            if placement.is_replicate():
                continue
            dim, size = placement.dim, shape[placement.dim]
            parts = axis_size(self.mesh, axis)
            if size % parts:
                raise ValueError(
                    f"dimension {dim} of size {size} does not divide over axis {axis!r} of "
                    f"{parts} ranks"
                )
            step = size // parts
            start = axis_index(self.mesh, axis) * step
            out[dim] = slice(start, start + step)
        return tuple(out)

    def shard(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``tensor``, contiguous."""
        return tensor[self.local_slices(tensor.shape)].contiguous()


def data_sharding(mesh: DeviceMesh, ndim: int, axis: str = "data") -> NamedSharding:
    """Shard dim 0 over ``axis``, replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, P())
