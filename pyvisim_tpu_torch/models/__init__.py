"""Model definitions in PyTorch (port of ``pyvisim_tpu/models``)."""
from . import quant, vgg
from .quant import QuantConv
from .vgg import VGGConvFeatures, params_from_jax

__all__ = ["quant", "vgg", "QuantConv", "VGGConvFeatures", "params_from_jax"]
