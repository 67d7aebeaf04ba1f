"""Model definitions in PyTorch (port of ``pyvisim_tpu/models``)."""
from . import quant, resnet, siamese, vgg
from .quant import QuantConv
from .resnet import ResNetTrunk
from .vgg import VGGConvFeatures, init_params, params_from_jax

__all__ = ["quant", "vgg", "resnet", "siamese", "QuantConv", "VGGConvFeatures", "ResNetTrunk",
           "init_params", "params_from_jax"]
