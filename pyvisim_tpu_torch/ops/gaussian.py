"""Separable Gaussian blur.

Port of ``pyvisim_tpu/ops/gaussian.py`` (``cv2.GaussianBlur`` with
OpenCV's REFLECT_101 border), the workhorse of the SIFT pyramid. Each 1-D
pass is a single-channel convolution in full float32: the JAX package
pins its banded matmuls above one-pass bf16 precision because coarser
blurs reshuffle weak DoG extrema, and cuDNN runs float32 convolutions in
TF32 unless told otherwise, so the passes run with TF32 off.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_kernel1d", "gaussian_blur", "gaussian_blur_batch"]


def gaussian_kernel1d(sigma: float, kernel_size: int | None = None) -> np.ndarray:
    """Sampled-Gaussian 1-D kernel, matching OpenCV's ``getGaussianKernel``
    for sizes where OpenCV computes (rather than looks up) coefficients."""
    if kernel_size is None:
        kernel_size = 2 * int(3.0 * sigma) + 1
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    r = (kernel_size - 1) // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _blur_hw(img: torch.Tensor, sigma: float, kernel_size: int) -> torch.Tensor:
    """Blur a (B, H, W) float32 stack along H, then W."""
    k = torch.from_numpy(gaussian_kernel1d(sigma, kernel_size)).to(img.device)
    r = (kernel_size - 1) // 2
    x = img[:, None]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        x = F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1))
        x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    return x[:, 0]


def gaussian_blur_batch(
    images: torch.Tensor, sigma: float, kernel_size: int | None = None
) -> torch.Tensor:
    """Blur a batch: (B, H, W) or (B, H, W, C) float32 tensor."""
    if kernel_size is None:
        kernel_size = 2 * int(3.0 * sigma) + 1
    images = images.to(torch.float32)
    if images.dim() == 4:
        b, h, w, c = images.shape
        x = images.permute(0, 3, 1, 2).reshape(b * c, h, w)
        out = _blur_hw(x, float(sigma), int(kernel_size))
        return out.reshape(b, c, h, w).permute(0, 2, 3, 1)
    return _blur_hw(images, float(sigma), int(kernel_size))


def gaussian_blur(
    image: torch.Tensor, sigma: float = 1.0, kernel_size: int | None = None
) -> torch.Tensor:
    """Blur one (H, W) or (H, W, C) image."""
    return gaussian_blur_batch(image[None], sigma, kernel_size)[0]
