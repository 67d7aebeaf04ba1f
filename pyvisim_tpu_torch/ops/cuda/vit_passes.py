"""The ViT block's float passes between its linears: SwiGLU over ``w12``'s
output, LayerScale + residual add with the LayerNorm that follows, and
DINOv3's RoPE rotation of q and k. The CUDA kernels' wrappers and their
plain PyTorch versions.

The kernels (``csrc/vit_passes.cu``) replace no TPU kernel: the JAX
package leaves these passes to XLA, which fuses them. On the card each
reads its inputs once and writes its outputs once, in bf16, where the
torch passes they replace moved temporaries through device memory:

- :func:`swiglu`: ``(M, 2H)`` contiguous -> ``(M, H)``, ``silu(x1) * x2``
  of the two halves, bit for bit with ``F.silu(x1) * x2`` (each rounded
  where the two torch passes round);
- :func:`add_norm`: ``x_new = x + y * gamma`` and ``F.layer_norm(x_new)``,
  bit for bit with ``torch.addcmul`` and ``F.layer_norm``: the kernel takes
  the LayerNorm's statistics as ATen's vectorised kernel does (Welford
  partials of 128 threads a row, combined in its order), as the source
  says;
- :func:`rope`: ``qkv`` ``(B, N, 3C)`` rotated in place, the q and k
  thirds of each image's last ``P`` rows (its patches; the CLS and
  register rows before them untouched) by a ``(2, P, hd / 2)`` float32
  table of cos and sin: each head's halves become ``x1 cos - x2 sin`` and
  ``x2 cos + x1 sin``, every product and the sum rounded to float32 and
  the result once to bf16, bit for bit with :func:`rope_reference`.

:func:`takes` is the route: the kernels take bf16 CUDA maps whose width is
a multiple of 8 (for the rotation, a half-head) while no gradient is
recorded (they have no backward); everything else (the CPU, float32) takes
the plain versions, :func:`swiglu_reference`, :func:`add_norm_reference`
and :func:`rope_reference`, which are the torch composition the ViT trunk
runs without the kernels. The wrappers raise on what the kernels do not
take and count launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_library
from .aggregate import launch_target

__all__ = ["takes", "swiglu", "swiglu_reference", "add_norm", "add_norm_reference", "rope",
           "rope_reference"]

# A thread of either kernel takes 8 bf16 columns (16 bytes) at a time.
_COLUMNS = 8


def _library() -> ctypes.CDLL:
    lib = load_library("vit_passes")
    if not getattr(lib, "_pyvisim_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vit_swiglu.argtypes = [ptr, ptr, i32, i32, i32, ptr]
        lib.vit_swiglu.restype = i32
        lib.vit_add_norm.argtypes = [ptr] * 5 + [ctypes.c_float] + [ptr] * 2 + [i32] * 3 + [ptr]
        lib.vit_add_norm.restype = i32
        lib.vit_rope.argtypes = [ptr, ptr] + [i32] * 6 + [ptr]
        lib.vit_rope.restype = i32
        lib.vit_passes_error_string.argtypes = [i32]
        lib.vit_passes_error_string.restype = ctypes.c_char_p
        lib._pyvisim_typed = True
    return lib


def takes(x: torch.Tensor, width: int) -> bool:
    """Whether the kernels take a map like ``x`` of ``width`` columns: bf16
    on CUDA, ``width`` a multiple of 8, no gradient recorded."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and width % _COLUMNS == 0
            and not torch.is_grad_enabled())


def swiglu_reference(x12: torch.Tensor) -> torch.Tensor:
    """``F.silu(x1) * x2`` of the halves of ``x12``'s last dimension, two
    torch passes over strided views."""
    x1, x2 = x12.chunk(2, dim=-1)
    return F.silu(x1) * x2


def add_norm_reference(x, y, gamma, weight, bias, eps: float):
    """``(x_new, h)``: ``torch.addcmul(x, y, gamma)`` and
    ``F.layer_norm(x_new)`` on ``weight``, ``bias``, ``eps``."""
    x = torch.addcmul(x, y, gamma)
    return x, F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def rope_reference(qkv: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``qkv`` ``(B, N, 3C)`` with the q and k thirds of each image's last
    ``P`` rows rotated in place by ``table`` ``(2, P, hd / 2)`` (cos, sin):
    each head's halves ``x1, x2`` become ``x1 cos - x2 sin`` and ``x2 cos
    + x1 sin`` in float32 (or wider), rounded once to ``qkv``'s dtype.
    Returns ``qkv``."""
    n, half = qkv.shape[1], table.shape[-1]
    qk = qkv[:, n - table.shape[1]:, :2 * qkv.shape[-1] // 3].unflatten(-1, (-1, 2, half))
    x1, x2 = qk.to(torch.promote_types(qkv.dtype, torch.float32)).unbind(-2)
    cos, sin = table[0, :, None], table[1, :, None]
    qk.copy_(torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-2))
    return qkv


def _check(name: str, t: torch.Tensor, shape=None, dtype=torch.bfloat16) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).removeprefix('torch.')}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launched(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: "
                           f"{lib.vit_passes_error_string(err).decode()} ({err})")


def swiglu(x12: torch.Tensor) -> torch.Tensor:
    """``silu(x1) * x2`` of the halves of ``x12 (..., 2H)``, contiguous bf16
    on CUDA with ``H`` a multiple of 8, as one kernel launch; ``(..., H)``."""
    _check("x12", x12)
    width = x12.shape[-1]
    if width % (2 * _COLUMNS):
        raise ValueError(f"the SwiGLU kernel takes halves of a multiple of {_COLUMNS} columns; "
                         f"got a width of {width}")
    if not x12.is_cuda:
        raise ValueError(f"the SwiGLU kernel takes a CUDA tensor, got one on {x12.device}")
    rows = x12.numel() // width if width else 0
    if rows >= 2**31:
        raise ValueError(f"the SwiGLU kernel takes fewer than 2**31 rows, got {rows}")
    out = torch.empty((*x12.shape[:-1], width // 2), dtype=x12.dtype, device=x12.device)
    if out.numel() == 0:
        return out
    lib = _library()
    index, stream = launch_target(x12.device)
    x12 = _aligned(x12)
    _launched(lib, lib.vit_swiglu(x12.data_ptr(), out.data_ptr(), rows, width // 2, index,
                                  stream), "SwiGLU")
    swiglu.launches += 1
    return out


swiglu.launches = 0


def add_norm(x, y, gamma, weight, bias, eps: float):
    """``(x_new, h)``: ``x + y * gamma`` and its LayerNorm on ``weight``,
    ``bias``, ``eps``, as one kernel launch. ``x`` and ``y`` ``(..., C)``
    contiguous bf16 on CUDA with ``C`` a multiple of 8; ``gamma``,
    ``weight``, ``bias`` ``(C,)`` bf16 on the same card."""
    _check("x", x)
    cols = x.shape[-1]
    _check("y", y, x.shape)
    for name, t in (("gamma", gamma), ("weight", weight), ("bias", bias)):
        _check(name, t, (cols,))
    if cols % _COLUMNS:
        raise ValueError(f"the add-norm kernel takes a multiple of {_COLUMNS} columns, got {cols}")
    if not x.is_cuda or any(t.device != x.device for t in (y, gamma, weight, bias)):
        raise ValueError(f"the add-norm kernel takes tensors on one CUDA card; x is on {x.device}")
    rows = x.numel() // cols if cols else 0
    if rows >= 2**31:
        raise ValueError(f"the add-norm kernel takes fewer than 2**31 rows, got {rows}")
    x_out, h = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return x_out, h
    lib = _library()
    index, stream = launch_target(x.device)
    x, y, gamma, weight, bias = (_aligned(t) for t in (x, y, gamma, weight, bias))
    _launched(lib, lib.vit_add_norm(x.data_ptr(), y.data_ptr(), gamma.data_ptr(),
                                    weight.data_ptr(), bias.data_ptr(), float(eps),
                                    x_out.data_ptr(), h.data_ptr(), rows, cols, index, stream),
              "add-norm")
    add_norm.launches += 1
    return x_out, h


add_norm.launches = 0


def rope(qkv: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``qkv`` ``(B, N, 3C)``, contiguous bf16 on CUDA and 16-byte aligned,
    with the q and k thirds of each image's last ``P`` rows rotated in place
    by ``table`` ``(2, P, hd / 2)`` float32 on the same card (``hd / 2`` a
    multiple of 8 dividing ``C / 2``), as one kernel launch; returns
    ``qkv``. The result is :func:`rope_reference`'s, bit for bit."""
    _check("qkv", qkv)
    _check("table", table, dtype=torch.float32)
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3C), got {tuple(qkv.shape)}")
    b, n, width = qkv.shape
    dim = width // 3
    if table.dim() != 3 or table.shape[0] != 2 or table.shape[1] > n:
        raise ValueError(f"table must be (2, P, hd / 2) with P <= {n}, got {tuple(table.shape)}")
    half = table.shape[-1]
    if half % _COLUMNS or half == 0 or dim % (2 * half):
        raise ValueError(f"the RoPE kernel takes half-heads of a multiple of {_COLUMNS} columns "
                         f"that divide C / 2 = {dim // 2}; got {half}")
    if not qkv.is_cuda or table.device != qkv.device:
        raise ValueError(f"the RoPE kernel takes tensors on one CUDA card; qkv is on {qkv.device}")
    if qkv.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("the RoPE kernel rotates in place and takes 16-byte aligned tensors")
    patches = table.shape[1]
    if b * patches >= 2**31:
        raise ValueError(f"the RoPE kernel takes fewer than 2**31 patch rows, got {b * patches}")
    if b * patches == 0:
        return qkv
    lib = _library()
    index, stream = launch_target(qkv.device)
    _launched(lib, lib.vit_rope(qkv.data_ptr(), table.data_ptr(), b, n, n - patches, dim, half,
                                index, stream), "RoPE")
    rope.launches += 1
    return qkv


rope.launches = 0
