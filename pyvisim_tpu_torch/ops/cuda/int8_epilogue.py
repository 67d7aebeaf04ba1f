"""The int8 gemm route's epilogue: ``torch._int_mm``'s int32 sums
dequantised, then BatchNorm, ReLU or a residual add and ReLU, in one pass.
The CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/int8_epilogue.cu``) replaces no TPU kernel: the JAX
package leaves the gemm route's convs and what follows them to XLA. It
reads the ``(B, H', W', Cout)`` int32 sums of ``models/quant.py:
int8_gemm_conv``, each image's activation scale ``sx``, the per-channel
weight scales ``sw`` and bias, and optionally a frozen BatchNorm and a
residual of the output's shape, and writes the output once, in bf16 or
float32. It rounds wherever the plain version's separate passes round, so
the two agree bit for bit:

- ``y = (float(acc) * (sx * sw) + b)`` rounded to the output's dtype, the
  ``QuantConv`` recipe's epilogue;
- ``F.batch_norm(y)`` on the running statistics, in float32 from the
  float32 parameters, rounded once, as ATen's own CUDA kernel computes it
  (``w * (y - mean) * rsqrt(var + eps) + b``, the last multiply and add
  fused);
- ``+ residual`` (rounded), then ``torch.relu``.

On the card ``F.batch_norm`` runs ATen's kernel for bf16 maps in every
layout and for float32 maps that are NCHW-contiguous; a channels-last
float32 map goes to cuDNN's inference kernel, which rounds otherwise (in
about 43 % of entries), so a float32 channels-last map keeps its
BatchNorm as a pass of its own (:func:`fuses_batch_norm`).

``bn`` is ``(weight, bias, running_mean, running_var, eps)``, as
``F.batch_norm`` takes them in eval mode. :func:`gemm_epilogue` takes the
plain version for CPU tensors and launches the kernel once for CUDA ones,
counting launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_library
from .aggregate import launch_target

__all__ = ["gemm_epilogue", "gemm_epilogue_reference", "batch_norm_tail",
           "fuses_batch_norm"]

# The kernel's thread takes 8 channels of a row.
_CHANNELS = 8


def _library() -> ctypes.CDLL:
    lib = load_library("int8_epilogue")
    if not getattr(lib, "_pyvisim_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.int8_epilogue.argtypes = ([ptr] * 8 + [ctypes.c_float] + [ptr] * 2
                                      + [i32] * 5 + [i32, ptr])
        lib.int8_epilogue.restype = i32
        lib.int8_epilogue_error_string.argtypes = [i32]
        lib.int8_epilogue_error_string.restype = ctypes.c_char_p
        lib._pyvisim_typed = True
    return lib


def fuses_batch_norm(dtype: torch.dtype, device: torch.device) -> bool:
    """Whether :func:`gemm_epilogue`'s BatchNorm repeats ``F.batch_norm`` on
    a channels-last map of ``dtype`` on ``device``: always on the CPU, where
    the epilogue is the plain chain; on the card for bf16 maps only (ATen's
    kernel), not for float32 ones (cuDNN's)."""
    return torch.device(device).type == "cpu" or dtype == torch.bfloat16


def batch_norm_tail(y: torch.Tensor, bn=None, relu: bool = False,
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """``(B, C, H, W)`` ``y`` through ``F.batch_norm`` on ``bn`` (when
    given), ``+ residual`` and ``torch.relu`` (when asked), each a torch
    pass of its own, as the trunk runs them. ``y`` is dropped as soon as
    BatchNorm has read it, so pass it as a temporary."""
    if bn is not None:
        weight, bias, mean, var, eps = bn
        y = F.batch_norm(y, mean, var, weight, bias, False, 0.0, eps)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def gemm_epilogue_reference(acc, sx, sw, b=None, *, dtype: torch.dtype, bn=None,
                            relu: bool = False, residual=None) -> torch.Tensor:
    """Plain version of :func:`gemm_epilogue`: ``float(acc) * (sx * sw) +
    b`` rounded to ``dtype``, then :func:`batch_norm_tail` on the NCHW
    views."""
    y = acc.to(torch.float32) * (sx.view(-1, 1, 1, 1) * sw.to(torch.float32))
    if b is not None:
        y = y + b.to(torch.float32)
    nchw = lambda t: None if t is None else t.permute(0, 3, 1, 2)
    return batch_norm_tail(nchw(y.to(dtype).contiguous()), bn, relu,
                           nchw(residual)).permute(0, 2, 3, 1)


def _f32(t: torch.Tensor, name: str, n: int, device) -> torch.Tensor:
    if tuple(t.shape) != (n,) or t.device != device:
        raise ValueError(f"{name} must be ({n},) on {device}; got {tuple(t.shape)} on {t.device}")
    return t.to(torch.float32).contiguous()


def gemm_epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                  b: torch.Tensor | None = None, *, dtype: torch.dtype, bn=None,
                  relu: bool = False, residual: torch.Tensor | None = None) -> torch.Tensor:
    """The epilogue of ``acc (B, H', W', Cout)`` int32 with per-image ``sx
    (B,)``, per-channel ``sw (Cout,)`` and ``b (Cout,)`` or None; ``bn`` as
    the module's note says, or None; ``residual`` of the output's shape and
    ``dtype``, or None. Returns ``(B, H', W', Cout)`` contiguous in ``dtype``.
    CPU tensors take :func:`gemm_epilogue_reference`; CUDA ones launch the
    kernel (float32 or bfloat16, Cout a multiple of 8), which equals it bit
    for bit."""
    if acc.dim() != 4 or acc.dtype != torch.int32:
        raise TypeError(f"acc must be (B, H, W, Cout) int32; got {tuple(acc.shape)} {acc.dtype}")
    if residual is not None and (residual.shape != acc.shape or residual.dtype != dtype):
        raise ValueError(f"residual must be {tuple(acc.shape)} {dtype}; got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    if acc.device.type == "cpu":
        return gemm_epilogue_reference(acc, sx, sw, b, dtype=dtype, bn=bn, relu=relu,
                                       residual=residual)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the epilogue kernel writes float32 or bfloat16, not {dtype}")
    bsz, ho, wo, cout = acc.shape
    dev = acc.device
    if cout % _CHANNELS or bsz * ho * wo >= 2**31:
        raise ValueError(f"the epilogue kernel takes Cout a multiple of {_CHANNELS} and fewer "
                         f"than 2**31 rows; got {tuple(acc.shape)}")
    sx, sw = _f32(sx, "sx", bsz, dev), _f32(sw, "sw", cout, dev)
    b = None if b is None else _f32(b, "b", cout, dev)
    if bn is not None:
        weight, bias, mean, var, eps = bn
        bn = [_f32(t, name, cout, dev) for t, name in
              ((weight, "bn weight"), (bias, "bn bias"), (mean, "running_mean"),
               (var, "running_var"))] + [float(eps)]
    acc = acc.contiguous()
    if residual is not None:
        residual = residual.contiguous()
        if residual.data_ptr() % 16:
            residual = residual.clone()
    if acc.data_ptr() % 16:
        acc = acc.clone()
    out = torch.empty(acc.shape, dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    index, stream = launch_target(dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    weight, bias, mean, var, eps = bn if bn is not None else (None,) * 4 + (0.0,)
    err = lib.int8_epilogue(
        acc.data_ptr(), sx.data_ptr(), sw.data_ptr(), ptr(b), ptr(weight), ptr(bias),
        ptr(mean), ptr(var), eps, ptr(residual), out.data_ptr(), int(dtype == torch.bfloat16),
        bsz * ho * wo, cout, ho * wo, int(relu), index, stream)
    if err != 0:
        raise RuntimeError(f"int8 gemm epilogue kernel failed: "
                           f"{lib.int8_epilogue_error_string(err).decode()} ({err})")
    gemm_epilogue.launches += 1
    return out


gemm_epilogue.launches = 0
