"""Model definitions in PyTorch (port of ``pyvisim_tpu/models``)."""
from . import vgg
from .vgg import VGGConvFeatures, params_from_jax

__all__ = ["vgg", "VGGConvFeatures", "params_from_jax"]
