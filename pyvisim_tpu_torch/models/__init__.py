"""Model definitions in PyTorch (port of ``pyvisim_tpu/models``)."""
from . import quant, resnet, siamese, vgg, vit
from .quant import QuantConv
from .resnet import ResNetTrunk
from .vgg import VGGConvFeatures, init_params, params_from_jax
from .vit import ViTTrunk

__all__ = ["quant", "vgg", "resnet", "siamese", "vit", "QuantConv", "VGGConvFeatures",
           "ResNetTrunk", "ViTTrunk", "init_params", "params_from_jax"]
