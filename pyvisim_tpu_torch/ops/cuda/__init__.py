"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel's source is ``pyvisim_tpu_torch/csrc/<name>.cu``; it is built
by ``nvcc`` at first use (see ``_build``). A wrapper takes its plain
version for CPU tensors and launches the kernel for CUDA tensors.
"""
from .aggregate import vlad_aggregate_batched, vlad_aggregate_reference

__all__ = ["vlad_aggregate_batched", "vlad_aggregate_reference"]
