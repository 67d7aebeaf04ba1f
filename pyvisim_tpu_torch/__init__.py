"""pyvisim_tpu_torch — the PyTorch/CUDA port of pyvisim_tpu.

The same image-similarity library (deep features, VLAD and Fisher-vector
encoders and their Pipeline, on-device vocabulary learning with K-Means,
GMM and PCA, cosine retrieval and its evaluation, gallery I/O and the
serving index, the retrieval losses, ResNet trunks and the Siamese
embedding trainer with its checkpoints, the Oxford Flowers-102 dataset,
spectral clustering and the clustering evaluation, and their multi-rank
paths on ``torch.distributed`` in ``parallel``) in PyTorch, with the JAX
package's TPU kernels rewritten as CUDA kernels for Hopper. The module layout
follows ``pyvisim_tpu`` so that each counterpart is found by name.

Entry points run on CUDA unless given ``device="cpu"``; without a card
they raise instead of falling back to the CPU.
"""

__version__ = "0.1.0"

__all__ = ["encoders", "features", "eval", "ops", "models", "io", "index", "datasets", "losses",
           "neural_networks", "checkpoint", "profiling", "parallel"]


def __getattr__(name):
    if name in __all__:
        import importlib

        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
