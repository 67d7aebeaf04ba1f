"""Lloyd (k-means) step statistics: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel is the ``lloyd_stats_f32`` entry point of ``csrc/aggregate.cu``,
which shares the VLAD kernel's nearest-centroid passes; it replaces the TPU
kernel ``pyvisim_tpu/ops/pallas/aggregate.py:_lloyd_kernel`` (wrapped there
by ``lloyd_stats_pallas``).

Bound: the assignment is ``2*N*K*D`` flops in full f32 (6.6 GFLOP at
N=25,088, D=514, K=256, ~0.1 ms on the card's f32 CUDA cores) against
51.6 MB of descriptors in, so the f32 rate bounds it. Labels must be the
plain argmin's, so the products are f32 FMAs, not TF32. Each cluster's
rows are summed in row order and the clusters' inertia in a fixed order,
so results repeat bit for bit; NaN and inf travel as in the plain version.
"""
from __future__ import annotations

import torch

from ..assign import pairwise_sqdist
from .aggregate import _library, check_kernel_inputs, launch_target, scratch

__all__ = ["lloyd_stats_reference", "lloyd_stats"]


def lloyd_stats_reference(
    desc: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor,
    *, return_labels: bool = False,
):
    """Plain version: matmul-form distances, ``argmin`` and a one-hot
    product. ``desc (N, D)``, ``mask (N,)`` weights, ``centers (K, D)`` ->
    ``sums (K, D)``, ``counts (K,)`` and the masked inertia
    ``sum_n m_n max(min_k ||x_n - c_k||^2, 0)`` (and the ``(N,)`` int32
    labels)."""
    d2 = pairwise_sqdist(desc, centers)
    best, labels = d2.min(dim=1)
    one_hot = torch.nn.functional.one_hot(labels, centers.shape[0]).to(desc.dtype)
    one_hot = one_hot * mask[:, None]
    out = (one_hot.T @ desc, one_hot.sum(dim=0), (best.clamp_min(0.0) * mask).sum())
    return out + (labels.to(torch.int32),) if return_labels else out


def _check(desc, mask, centers) -> None:
    check_kernel_inputs(desc=desc, mask=mask, centers=centers)
    if desc.dim() != 2 or mask.shape != desc.shape[:1]:
        raise ValueError(
            f"expected desc (N, D) and mask (N,); got {tuple(desc.shape)} and "
            f"{tuple(mask.shape)}"
        )
    if centers.dim() != 2 or centers.shape[1] != desc.shape[1] or centers.shape[0] < 1:
        raise ValueError(
            f"centers must be (K, {desc.shape[1]}) with K >= 1; got {tuple(centers.shape)}"
        )


def lloyd_stats(
    desc: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor,
    *, return_labels: bool = False,
):
    """Lloyd statistics ``(sums, counts, inertia[, labels])`` of one set;
    arguments as :func:`lloyd_stats_reference`.

    CPU tensors take :func:`lloyd_stats_reference`; CUDA tensors launch the
    kernel, which raises if it fails. ``launches`` counts the kernel's
    launches. The kernel's labels are -1 for rows of zero weight.
    """
    _check(desc, mask, centers)
    if desc.device.type == "cpu":
        return lloyd_stats_reference(desc, mask, centers, return_labels=return_labels)
    if desc.device.type != "cuda":
        raise ValueError(f"lloyd_stats runs on cpu or cuda, not {desc.device}")
    n, d = desc.shape
    k = centers.shape[0]
    if n >= 2**31 or k * d >= 2**62:
        raise ValueError(f"set too large for the kernel: {tuple(desc.shape)}")
    dev = desc.device
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    inertia = torch.empty((), dtype=torch.float32, device=dev)
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    out = (sums, counts, inertia, labels) if return_labels else (sums, counts, inertia)
    if n == 0:
        for t in out[:3]:
            t.zero_()
        return out
    lib = _library()
    index, stream = launch_target(dev)
    work = scratch(lib, 1, n, d, k, True, dev)
    err = lib.lloyd_stats_f32(
        desc.data_ptr(), mask.data_ptr(), centers.data_ptr(), work.data_ptr(),
        labels.data_ptr(), sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(), n, d, k,
        index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"lloyd_stats kernel failed: {lib.vlad_error_string(err).decode()} ({err})"
        )
    lloyd_stats.launches += 1
    return out


lloyd_stats.launches = 0
