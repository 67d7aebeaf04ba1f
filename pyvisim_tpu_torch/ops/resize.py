"""Antialiased linear image resize.

Port of ``pyvisim_tpu/ops/resize.py``: ``F.interpolate`` with bilinear
taps, ``antialias=True`` and ``align_corners=False``, in float32, which
agrees with ``jax.image.scale_and_translate(..., method="linear",
antialias=True)``.

The JAX package pads ragged images to a ladder of bucket sizes
(``bucket_side``) so that each compiled graph serves many shapes, and
renormalises by a resampled mask; it documents that path as numerically
the unpadded resize. PyTorch runs eagerly with no per-shape compile, so
the port resizes each image at its own shape and needs no ladder.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["masked_linear_resize"]


def masked_linear_resize(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``(B, H, W, C)`` -> ``(B, out_size, out_size, C)``, resampled in
    float32 and cast back to ``x.dtype`` (a bf16 scale would shift the
    taps)."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2).to(torch.float32),
        size=(out_size, out_size),
        mode="bilinear",
        align_corners=False,
        antialias=True,
    )
    return y.permute(0, 2, 3, 1).to(x.dtype)
