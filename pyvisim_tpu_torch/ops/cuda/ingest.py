"""SIFT's image ingest: raw uint8 images turned gray and letterboxed on the
device. The CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/ingest.cu``) replaces no TPU kernel: the JAX package
turns images gray and letterboxes them on the host. It takes one chunk of
raw images, 2-D gray or 3-D with three or more channels (RGB, RGBA), and
writes the ``(B, size, size)`` uint8 base tensor that ``ops/sift.py``'s
SIFT core takes, equal bit for bit to ``_letterbox(_to_gray_u8(img),
size)`` on the host. The bytes bound it: the raw chunk read once, the base
written once.

The caller describes the chunk with two host tables (``ops/sift.py``
builds them):

- ``layout``, ``(B, 8)`` int64, one row an image: the offset of its first
  byte in ``raw`` (each image C-contiguous there), its height, width and
  channels (1 for a 2-D image), its letterboxed height ``nh`` and width
  ``nw`` (at most ``size``), and where its taps start in ``taps``;
- ``taps``, 1-D int64: for an image, from its x start, ``sx``, ``sx1``,
  ``ax0``, ``ax1`` (``nw`` each: the two source columns and their 11-bit
  weights) and, from its y start, ``sy0``, ``sy1``, ``by0``, ``by1``
  (``nh`` each), as ``ops/sift.py:_letterbox_taps`` gives them.

:func:`gray_letterbox` takes its plain version for a CPU ``raw`` and
launches the kernel once for a CUDA one, counting launches in
``.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import load_library
from .aggregate import launch_target

__all__ = ["gray_letterbox", "gray_letterbox_reference", "COLUMNS"]

COLUMNS = ("offset", "height", "width", "channels", "nh", "nw", "tap_x", "tap_y")
_WEIGHT_ONE = 2048
# The kernel's grid: images along y, a size x size image's pixels along x.
_MAX_IMAGES = 65535
_MAX_SIZE = 32768


def _library() -> ctypes.CDLL:
    lib = load_library("ingest")
    if not getattr(lib, "_pyvisim_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ingest_gray_letterbox.argtypes = [ptr, ptr, i32, i32, ptr, i32, ptr]
        lib.ingest_gray_letterbox.restype = i32
        lib.ingest_error_string.argtypes = [i32]
        lib.ingest_error_string.restype = ctypes.c_char_p
        lib._pyvisim_typed = True
    return lib


def _check(raw, layout, taps, size: int) -> None:
    """Raise on anything the kernel does not take. Reads the host tables
    only (one row an image, and each distinct tap range once)."""
    if not isinstance(raw, torch.Tensor):
        raise TypeError(f"raw must be a torch.Tensor, got {type(raw)}")
    if raw.dtype != torch.uint8:
        raise TypeError(f"raw must be uint8 pixels, got {raw.dtype}")
    if not raw.is_contiguous():
        raise ValueError("raw must be contiguous")
    if raw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the ingest kernel runs on cpu or cuda, not {raw.device}")
    for name, table in (("layout", layout), ("taps", taps)):
        if not isinstance(table, np.ndarray) or table.dtype != np.int64:
            raise TypeError(f"{name} must be an int64 numpy array on the host")
    if layout.ndim != 2 or layout.shape[1] != len(COLUMNS) or taps.ndim != 1:
        raise ValueError(f"layout must be (B, {len(COLUMNS)}) and taps 1-D, got "
                         f"{layout.shape} and {taps.shape}")
    if not 1 <= size <= _MAX_SIZE or len(layout) > _MAX_IMAGES:
        raise ValueError(f"size must lie in 1..{_MAX_SIZE} and B in 0..{_MAX_IMAGES}")
    off, h, w, c, nh, nw, tx, ty = layout.T
    if (h < 1).any() or (w < 1).any() or (c < 1).any():
        raise ValueError("every image needs a height, a width and a channel")
    if (c == 2).any():
        raise ValueError("an image has 1 channel (gray) or 3 or more (R, G, B first), not 2")
    if (off < 0).any() or (off + h * w * c > raw.numel()).any():
        raise ValueError(f"an image lies outside raw's {raw.numel()} bytes")
    if (nh < 1).any() or (nw < 1).any() or (nh > size).any() or (nw > size).any():
        raise ValueError(f"letterboxed sizes must lie in 1..{size}")
    # Each distinct (start, count, source extent) of the x and y taps.
    ranges = {*zip(tx.tolist(), nw.tolist(), w.tolist()),
              *zip(ty.tolist(), nh.tolist(), h.tolist())}
    for start, n, src in ranges:
        if start < 0 or start + 4 * n > len(taps):
            raise ValueError("a tap range lies outside taps")
        index, weight = taps[start : start + 2 * n], taps[start + 2 * n : start + 4 * n]
        if index.min() < 0 or index.max() >= src or weight.min() < 0 or weight.max() > _WEIGHT_ONE:
            raise ValueError(f"taps must index 0..{src - 1} with weights 0..{_WEIGHT_ONE}")


def gray_letterbox_reference(raw: torch.Tensor, layout: np.ndarray, taps: np.ndarray,
                             size: int) -> torch.Tensor:
    """Plain version of :func:`gray_letterbox`, image by image, in the
    kernel's arithmetic: the float64 gray of numpy's ``_to_gray_u8``
    (``torch.round`` rounds half to even, as ``np.round``), then
    ``_resize_linear``'s fixed-point blend in int32."""
    _check(raw, layout, taps, size)
    flat, dev = raw.reshape(-1), raw.device
    out = torch.zeros((len(layout), size, size), dtype=torch.uint8, device=dev)
    tap_t = torch.from_numpy(taps).to(dev)
    for i, (off, h, w, c, nh, nw, tx, ty) in enumerate(layout.tolist()):
        img = flat[off : off + h * w * c].reshape(h, w, c)
        if c == 1:
            gray = img[..., 0].to(torch.int32)
        else:
            rgb = img[..., :3].to(torch.float64)
            gray = torch.round(rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587
                               + rgb[..., 2] * 0.114).to(torch.int32)
        sx0, sx1, ax0, ax1 = tap_t[tx : tx + 4 * nw].view(4, nw)
        sy0, sy1, by0, by1 = tap_t[ty : ty + 4 * nh].view(4, nh)
        rows = gray[:, sx0] * ax0.to(torch.int32) + gray[:, sx1] * ax1.to(torch.int32)
        by0, by1 = by0.to(torch.int32)[:, None], by1.to(torch.int32)[:, None]
        blend = (((rows[sy0] >> 4) * by0) >> 16) + (((rows[sy1] >> 4) * by1) >> 16)
        out[i, :nh, :nw] = ((blend + 2) >> 2).clamp(0, 255).to(torch.uint8)
    return out


def gray_letterbox(raw: torch.Tensor, layout: np.ndarray, taps: np.ndarray,
                   size: int) -> torch.Tensor:
    """The chunk described by ``layout`` and ``taps`` (host int64 tables,
    see the module's note) turned gray and letterboxed: ``(B, size, size)``
    uint8 on ``raw``'s device. ``raw`` is a contiguous uint8 tensor of any
    shape, read as flat bytes. A CPU ``raw`` takes
    :func:`gray_letterbox_reference`; a CUDA one launches the kernel once,
    after one copy of both tables to the device."""
    _check(raw, layout, taps, size)
    if raw.device.type == "cpu":
        return gray_letterbox_reference(raw, layout, taps, size)
    b = len(layout)
    out = torch.empty((b, size, size), dtype=torch.uint8, device=raw.device)
    if b:
        meta = torch.from_numpy(np.concatenate([layout.reshape(-1), taps])).to(raw.device)
        lib = _library()
        index, stream = launch_target(raw.device)
        err = lib.ingest_gray_letterbox(raw.data_ptr(), meta.data_ptr(), b, size,
                                        out.data_ptr(), index, stream)
        if err != 0:
            raise RuntimeError(
                f"gray_letterbox kernel failed: {lib.ingest_error_string(err).decode()} ({err})")
        gray_letterbox.launches += 1
    return out


gray_letterbox.launches = 0
