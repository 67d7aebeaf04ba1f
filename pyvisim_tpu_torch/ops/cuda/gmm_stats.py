"""Diagonal-GMM posterior statistics: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/gmm_stats.cu``) replaces the TPU kernel
``pyvisim_tpu/ops/pallas/aggregate.py:_fisher_kernel`` (wrapped there by
``gmm_em_stats_pallas`` and ``fisher_stats_pallas``). That kernel takes one
``(N, D)`` set; this one takes a batch of ``(B, N, D)`` sets in one call,
so a Fisher-vector encode of a batch and an EM step on one large set are
each a single call.

Bound: the products are ``8*B*N*K*D`` flops in full f32 on the rows that
carry weight (13.2 GFLOP at B=128, N=196, D=257, K=256, ~0.2 ms on the
card's f32 CUDA cores) against ~93 MB in and out, so the f32 rate bounds
it. The EM step needs full f32 (JAX pins ``Precision.HIGHEST``), so the
kernel multiplies in f32 FMAs, not TF32. Its passes are GEMM-shaped: logp
as ``[x, x^2]`` against ``[minv | -half_inv]`` with the softmax on chip for
K <= 256, then ``[s1 | s2]`` as ``q^T [x, x^2]``; blocks of rows that all
weigh 0 skip their products when they provably add nothing (see the
source).
"""
from __future__ import annotations

import ctypes

import torch

from ..assign import gmm_terms
from ._build import load_library
from .aggregate import check_kernel_inputs, launch_target

__all__ = ["gmm_stats_reference", "gmm_stats_batched"]


def gmm_stats_reference(
    desc: torch.Tensor, mask: torch.Tensor, weights: torch.Tensor,
    means: torch.Tensor, covariances: torch.Tensor, *, with_ll: bool = False,
):
    """Plain version in matmul form. ``desc (B, N, D)``, ``mask (B, N)``
    weights, a diag GMM ``weights (K,)``, ``means``/``covariances (K, D)``
    -> unnormalised ``s0 (B, K)``, ``s1``/``s2 (B, K, D)`` (and the masked
    log-likelihood ``ll (B,)`` with ``with_ll``)."""
    minv, half_inv, const = gmm_terms(weights, means, covariances)
    d2 = desc * desc
    logp = desc @ minv.T - d2 @ half_inv.T + const
    q = torch.softmax(logp, dim=-1) * mask[..., None]
    qt = q.transpose(1, 2)
    out = (q.sum(dim=1), qt @ desc, qt @ d2)
    if with_ll:
        out += ((torch.logsumexp(logp, dim=-1) * mask).sum(dim=1),)
    return out


def _check(desc, mask, weights, means, covariances) -> None:
    check_kernel_inputs(desc=desc, mask=mask, weights=weights, means=means,
                        covariances=covariances)
    if desc.dim() != 3 or mask.shape != desc.shape[:2]:
        raise ValueError(
            f"expected desc (B, N, D) and mask (B, N); got {tuple(desc.shape)} "
            f"and {tuple(mask.shape)}"
        )
    k = weights.shape[0] if weights.dim() == 1 else -1
    want = (k, desc.shape[2])
    if k < 1 or tuple(means.shape) != want or tuple(covariances.shape) != want:
        raise ValueError(
            f"expected weights (K,), means and covariances (K, {desc.shape[2]}); got "
            f"{tuple(weights.shape)}, {tuple(means.shape)}, {tuple(covariances.shape)}"
        )


def _library() -> ctypes.CDLL:
    lib = load_library("gmm_stats")
    if not getattr(lib, "_pyvisim_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gmm_stats_f32.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
        lib.gmm_stats_f32.restype = i32
        lib.gmm_stats_scratch_floats.argtypes = [i32] * 4
        lib.gmm_stats_scratch_floats.restype = ctypes.c_longlong
        lib.gmm_error_string.argtypes = [i32]
        lib.gmm_error_string.restype = ctypes.c_char_p
        lib._pyvisim_typed = True
    return lib


def gmm_stats_batched(
    desc: torch.Tensor, mask: torch.Tensor, weights: torch.Tensor,
    means: torch.Tensor, covariances: torch.Tensor, *, with_ll: bool = False,
):
    """Unnormalised GMM statistics ``(s0, s1, s2[, ll])`` of a batch of
    descriptor sets; arguments as :func:`gmm_stats_reference`.

    CPU tensors take :func:`gmm_stats_reference`; CUDA tensors launch the
    kernel, which raises if it fails. ``launches`` counts the kernel's
    launches.
    """
    _check(desc, mask, weights, means, covariances)
    if desc.device.type == "cpu":
        return gmm_stats_reference(desc, mask, weights, means, covariances, with_ll=with_ll)
    if desc.device.type != "cuda":
        raise ValueError(f"gmm_stats_batched runs on cpu or cuda, not {desc.device}")
    b, n, d = desc.shape
    k = means.shape[0]
    if b * n >= 2**31 or b * n * k >= 2**62:
        raise ValueError(f"batch too large for the kernel: {tuple(desc.shape)}, K={k}")
    dev = desc.device
    s0 = torch.empty((b, k), dtype=torch.float32, device=dev)
    s1 = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    s2 = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    ll = torch.empty((b,), dtype=torch.float32, device=dev)
    out = (s0, s1, s2, ll) if with_ll else (s0, s1, s2)
    if b * n == 0:
        return tuple(t.zero_() for t in out)
    lib = _library()
    scratch = torch.empty((lib.gmm_stats_scratch_floats(b, n, d, k),), dtype=torch.float32,
                          device=dev)
    err = lib.gmm_stats_f32(
        desc.data_ptr(), mask.data_ptr(), weights.data_ptr(), means.data_ptr(),
        covariances.data_ptr(), scratch.data_ptr(), s0.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        ll.data_ptr() if with_ll else None, b, n, d, k, *launch_target(dev),
    )
    if err != 0:
        raise RuntimeError(
            f"gmm_stats kernel failed: {lib.gmm_error_string(err).decode()} ({err})"
        )
    gmm_stats_batched.launches += 1
    return out


gmm_stats_batched.launches = 0
