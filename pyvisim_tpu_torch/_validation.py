"""Image validation helpers (port of ``pyvisim_tpu/_validation.py``).

numpy HWC images in [0, 255], torch CHW images in [0, 1], integer 2-D
masks.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ._errors import InvalidImageError

__all__ = ["is_numpy_image", "is_torch_image", "check_is_image", "validate_image"]


def is_numpy_image(image: np.ndarray, pos: int = 0) -> None:
    """Validate a numpy image: (H, W, 3) in [0, 255], or an integer 2-D mask."""
    if image.ndim == 2:
        if not np.all(image == image.astype(np.int64)):
            raise InvalidImageError(
                f"Mask values must be integers. Got min={image.min()} and max={image.max()}."
            )
    else:
        if image.shape[2] != 3:
            raise InvalidImageError(
                f"NumPy 3D images must have shape (H, W, 3). Got {image.shape}."
            )
        if image.min() < 0 or image.max() > 255:
            raise InvalidImageError(
                f"Image values must be in the range [0, 255]. "
                f"Got min={image.min()} and max={image.max()} for position {pos}."
            )


def is_torch_image(image: torch.Tensor, pos: int = 0, tol: float = 1e-5) -> None:
    """Validate a torch image: (3, H, W) in [0, 1], or an integer 2-D mask."""
    if image.dim() == 2:
        if not torch.all(image == image.to(torch.int)):
            raise InvalidImageError(
                f"Mask values must be integers. Got min={image.min().item()} "
                f"and max={image.max().item()} for position {pos}."
            )
    else:
        if image.shape[0] != 3:
            raise InvalidImageError(
                f"Torch 3D images must have shape (3, H, W). Got {tuple(image.shape)}."
            )
        if image.min().item() < 0.0 - tol or image.max().item() > 1.0 + tol:
            raise InvalidImageError(
                f"Image values must be in the range [0, 1]. Got min={image.min().item()} "
                f"and max={image.max().item()} for position {pos}."
            )


def validate_image(image: Any, pos: int = 0, tol: float = 1e-5) -> None:
    """Validate a single image of either supported format."""
    if not hasattr(image, "shape"):
        raise InvalidImageError(
            f"Argument at position {pos} of type {type(image)} does not have "
            "attribute 'shape'. So it is neither a numpy array nor a torch tensor."
        )
    if not 2 <= len(image.shape) <= 3:
        raise InvalidImageError(
            f"Image must be 2D or 3D. Got shape {image.shape} for position {pos}."
        )
    if isinstance(image, np.ndarray):
        is_numpy_image(image, pos)
    elif torch.is_tensor(image):
        is_torch_image(image, pos, tol)
    else:
        raise InvalidImageError(
            f"Input must be a numpy array or a torch tensor, not {type(image)}."
        )


def check_is_image(
    arg_positions: tuple | None = None,
    kwarg_positions: tuple | None = None,
    tol: float = 1e-5,
):
    """Decorator validating selected arguments as images (zero-based
    positions; by default the first positional argument)."""

    def decorator(func):
        def wrapper(*args, **kwargs):
            targets = []
            if arg_positions:
                targets.extend(args[p] for p in arg_positions)
            if kwarg_positions:
                vals = list(kwargs.values())
                targets.extend(v for i, v in enumerate(vals) if i in kwarg_positions)
            if not arg_positions and not kwarg_positions:
                targets.append(args[0])
            for pos, image in enumerate(targets):
                validate_image(image, pos, tol)
            return func(*args, **kwargs)

        return wrapper

    return decorator
