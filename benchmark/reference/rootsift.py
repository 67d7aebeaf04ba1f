"""Plain RootSIFT at the configuration's SiftConfig, on the frozen plain
pipeline of ``reference/sift.py``.

``precision`` lowers parts for the control: ``{"pyramid": "tf32"}`` runs
the pyramid's blurs in TF32, ``{"atlas": "float8_e4m3fn"}`` stores the
gradient atlas in float8.
"""
from __future__ import annotations

import numpy as np
import torch

from . import sift

STATED = {"pyramid": "float32", "atlas": "bfloat16"}
CONTROL = {"pyramid": "tf32", "atlas": "float8_e4m3fn"}


def config(cfg: dict, precision=None) -> sift.SiftConfig:
    precision = {**STATED, **(precision or {})}
    ex = cfg["extractor"]
    return sift.SiftConfig(
        n_octave_layers=ex["n_octave_layers"], sigma=ex["sigma"],
        contrast_threshold=ex["contrast_threshold"], edge_threshold=ex["edge_threshold"],
        process_size=ex["process_size"], upscale=ex["upscale"],
        max_keypoints=ex["max_keypoints"], atlas_dtype=precision["atlas"],
        multi_orientation=ex["multi_orientation"],
        pyramid_tf32=precision["pyramid"] == "tf32",
    )


def descriptors(cfg: dict, weights: dict, images: np.ndarray, device, precision=None,
                block: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """``(desc (n, max_keypoints, 128) float32, mask (n, max_keypoints))``
    of uint8 RGB images ``(n, H, W, 3)``; ``weights`` is unused."""
    return sift.describe(list(images), config(cfg, precision), device, root_sift=True,
                         batch=block)
