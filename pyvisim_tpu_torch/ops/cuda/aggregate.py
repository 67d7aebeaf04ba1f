"""Batched VLAD residual aggregation: the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel (``csrc/aggregate.cu``) replaces the TPU kernel
``pyvisim_tpu/ops/pallas/aggregate.py:_vlad_kernel`` (wrapped there by
``vlad_aggregate_pallas``). That kernel takes one ``(N, D)`` set and the
JAX package vmaps it over images; this one takes the whole ``(B, N, D)``
batch in one call.

Bound: the nearest-centroid assignment is ``2*B*N*K*D`` flops in full
f32 (6.6 GFLOP at B=128, N=196, D=514, K=256, ~0.1 ms on the card's f32
CUDA cores), against ~120 MB of descriptors in and residuals out, so the
f32 rate bounds it. TF32 would flip labels near ties, so the kernel uses
f32 FMAs; the (N, K) distance block never reaches device memory, and the
accumulation walks each set in order without atomics, so results repeat
bit for bit. See the source for the three passes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..assign import nearest_centroid
from ._build import load_library

__all__ = ["vlad_aggregate_reference", "vlad_aggregate_batched"]


def vlad_aggregate_reference(
    desc: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor,
    *, return_labels: bool = False,
):
    """Plain version: matmul-form distances, ``argmin`` and a one-hot
    ``bmm``. ``desc (B, N, D)``, ``mask (B, N)`` weights, ``centers (K, D)``
    -> ``(B, K, D)`` residual sums (and the ``(B, N)`` int32 labels)."""
    labels = nearest_centroid(desc, centers)
    one_hot = F.one_hot(labels.long(), centers.shape[0]).to(desc.dtype)
    one_hot = one_hot * mask[..., None]
    sums = torch.bmm(one_hot.transpose(1, 2), desc)
    out = sums - one_hot.sum(dim=1)[..., None] * centers
    return (out, labels) if return_labels else out


def _check(desc, mask, centers) -> None:
    for name, t in (("desc", desc), ("mask", mask), ("centers", centers)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != desc.device:
            raise ValueError(f"{name} is on {t.device}, desc on {desc.device}")
    if desc.dim() != 3 or mask.shape != desc.shape[:2]:
        raise ValueError(
            f"expected desc (B, N, D) and mask (B, N); got {tuple(desc.shape)} "
            f"and {tuple(mask.shape)}"
        )
    if centers.dim() != 2 or centers.shape[1] != desc.shape[2] or centers.shape[0] < 1:
        raise ValueError(
            f"centers must be (K, {desc.shape[2]}) with K >= 1; got {tuple(centers.shape)}"
        )


def _library() -> ctypes.CDLL:
    lib = load_library("aggregate")
    if not getattr(lib, "_pyvisim_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vlad_aggregate_f32.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.vlad_aggregate_f32.restype = i32
        lib.vlad_accumulate_cols.argtypes = [i32, i32]
        lib.vlad_accumulate_cols.restype = i32
        lib.vlad_error_string.argtypes = [i32]
        lib.vlad_error_string.restype = ctypes.c_char_p
        lib._pyvisim_typed = True
    return lib


def vlad_aggregate_batched(
    desc: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor,
    *, return_labels: bool = False,
):
    """Unnormalised VLAD ``(B, K, D)`` of a batch of descriptor sets.

    CPU tensors take :func:`vlad_aggregate_reference`; CUDA tensors launch
    the kernel, which raises if it fails. ``launches`` counts the kernel's
    launches. With ``return_labels`` the ``(B, N)`` int32 labels come too.
    """
    _check(desc, mask, centers)
    if desc.device.type == "cpu":
        return vlad_aggregate_reference(desc, mask, centers, return_labels=return_labels)
    if desc.device.type != "cuda":
        raise ValueError(f"vlad_aggregate_batched runs on cpu or cuda, not {desc.device}")
    b, n, d = desc.shape
    k = centers.shape[0]
    if b * n >= 2**31 or b * k * d >= 2**62:
        raise ValueError(f"batch too large for the kernel: {tuple(desc.shape)}, K={k}")
    out = torch.empty((b, k, d), dtype=torch.float32, device=desc.device)
    labels = torch.empty((b, n), dtype=torch.int32, device=desc.device)
    if b * n == 0:
        out.zero_()
        return (out, labels) if return_labels else out
    lib = _library()
    dev = desc.device.index if desc.device.index is not None else torch.cuda.current_device()
    if lib.vlad_accumulate_cols(k, dev) == 0:
        raise ValueError(f"K={k} centers do not fit the kernel's shared-memory accumulator")
    c2 = torch.empty((k,), dtype=torch.float32, device=desc.device)
    stream = torch.cuda.current_stream(desc.device).cuda_stream
    err = lib.vlad_aggregate_f32(
        desc.data_ptr(), mask.data_ptr(), centers.data_ptr(), c2.data_ptr(),
        labels.data_ptr(), out.data_ptr(), b, n, d, k, dev, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"vlad_aggregate kernel failed: {lib.vlad_error_string(err).decode()} ({err})"
        )
    vlad_aggregate_batched.launches += 1
    return (out, labels) if return_labels else out


vlad_aggregate_batched.launches = 0
