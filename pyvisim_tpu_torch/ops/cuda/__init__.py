"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel's source is in ``pyvisim_tpu_torch/csrc``; it is built by
``nvcc`` at first use (see ``_build``). Each module holds a kernel's
wrapper, its launch count and its plain version: the wrapper takes the
plain version for CPU tensors and launches the kernel for CUDA tensors.
"""
from . import (aggregate, conv, gmm_stats, ingest, int8_epilogue, lloyd_stats, sift_window,
               vit_passes)

__all__ = ["aggregate", "conv", "gmm_stats", "ingest", "int8_epilogue", "lloyd_stats",
           "sift_window", "vit_passes"]
