"""pyvisim_tpu_torch — the PyTorch/CUDA port of pyvisim_tpu.

The same image-similarity library (deep-feature and VLAD encoders,
cosine retrieval and its evaluation) in PyTorch, with the JAX package's
TPU kernels rewritten as CUDA kernels for Hopper. The module layout
follows ``pyvisim_tpu`` so that each counterpart is found by name.

Entry points run on CUDA unless given ``device="cpu"``; without a card
they raise instead of falling back to the CPU.
"""

__version__ = "0.1.0"

__all__ = ["encoders", "features", "eval", "ops", "models"]


def __getattr__(name):
    if name in __all__:
        import importlib

        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
