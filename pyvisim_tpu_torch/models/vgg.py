"""VGG convolutional trunks in PyTorch (the deep feature extractor's backbone).

Port of ``pyvisim_tpu/models/vgg.py``: the conv/ReLU/pool trunk truncated
at a chosen conv layer, returning that layer's **post-ReLU** output, which
is what the reference's forward hook observably reads under torchvision's
in-place ReLU.

The trunk is an ``nn.Sequential`` named ``features`` with torchvision's
layer indices (conv, ReLU, pool), so a torchvision VGG ``state_dict``
loads into it as it is. Weights from the JAX package cross through
:func:`params_from_jax`.

With ``int8=True`` the trunk routes its convs as the JAX package's does
(``pyvisim_tpu/models/vgg.py:95-99``): each conv is a
:class:`~.quant.RoutedConv` with its ReLU, int8 where the conv's input
height lies in [``int8_min_spatial``, ``int8_max_spatial``] and it has >= 64
channels. Each conv that a pool follows runs fused with its ReLU and pool:
kernel 8 where it is int8, kernel 7 otherwise. The other int8 convs run
through kernel 8 alone, the other float convs through cuDNN. The int8
trunk runs channels-last in every dtype.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .quant import RoutedConv, lecun_normal_

__all__ = [
    "VGG_CFGS",
    "VGGConvFeatures",
    "init_params",
    "params_from_jax",
    "num_conv_layers",
    "conv_out_channels",
]

# Conv output channels; "M" = 2x2 max pool (torchvision's "A"/"D"/"E").
VGG_CFGS: Dict[str, Sequence] = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


def num_conv_layers(cfg_name: str = "vgg16") -> int:
    return sum(1 for c in VGG_CFGS[cfg_name] if c != "M")


def conv_out_channels(cfg_name: str, layer_index: int) -> int:
    chans = [c for c in VGG_CFGS[cfg_name] if c != "M"]
    return chans[layer_index]


def _conv_feature_indices(cfg_name: str, layer_index: int):
    """torchvision ``features.{i}`` index of each conv up to ``layer_index``."""
    target = layer_index % num_conv_layers(cfg_name)
    out, idx = [], 0
    for item in VGG_CFGS[cfg_name]:
        if item == "M":
            idx += 1
            continue
        out.append(idx)
        if len(out) > target:
            break
        idx += 2
    return out


class VGGConvFeatures(nn.Module):
    """The convolutional trunk of a VGG network, truncated at ``layer_index``.

    ``forward(x (B, 3, H, W)) -> (B, C, H', W')``, the post-ReLU output of
    conv layer ``layer_index`` (negative indices allowed). The ReLUs run in
    place, which saves one activation per layer; nothing else reads the
    conv outputs.

    ``int8``: route the middle convs through int8 (see the module
    docstring); ``int8_min_spatial``/``int8_max_spatial`` bound the input
    height of an int8 conv, as in the JAX package. Each conv position then
    holds a :class:`~.quant.RoutedConv` and the ReLU and pool positions it fuses
    hold ``nn.Identity``, so the ``features.{i}`` keys stay torchvision's.
    The input must be channels-last on CUDA. ``int8=False`` is the plain
    cuDNN trunk.

    ``generator``: the default initialisation draws, as Flax's ``nn.Conv``
    does, lecun-normal kernels (truncated normal, fan-in scaling) and zero
    biases, from this generator (seed 0 when ``None``) on the CPU. The
    values differ from Flax's; parity tests carry weights across instead.
    """

    def __init__(
        self,
        cfg_name: str = "vgg16",
        layer_index: int = -1,
        int8: bool = False,
        generator: torch.Generator | None = None,
        int8_min_spatial: int = 28,
        int8_max_spatial: int = 56,
    ):
        super().__init__()
        n_convs = num_conv_layers(cfg_name)
        if not -n_convs <= layer_index < n_convs:
            raise IndexError(
                f"Model {cfg_name} has only {n_convs} convolutional layers. "
                f"Got layer_index={layer_index}."
            )
        self.cfg_name = cfg_name
        self.layer_index = layer_index
        target = layer_index % n_convs
        cfg = VGG_CFGS[cfg_name]
        layers, in_ch, conv_i = [], 3, 0
        for pos, item in enumerate(cfg):
            if item == "M":
                layers.append(nn.Identity() if int8 else nn.MaxPool2d(2, 2))
                continue
            if int8:
                # The trunk ends at its target conv, before any pool after it.
                pool = conv_i != target and pos + 1 < len(cfg) and cfg[pos + 1] == "M"
                layers.append(RoutedConv(in_ch, item, relu=True, pool=pool,
                                         min_spatial=int8_min_spatial,
                                         max_spatial=int8_max_spatial))
                layers.append(nn.Identity())
            else:
                layers.append(nn.Conv2d(in_ch, item, 3, padding=1))
                layers.append(nn.ReLU(inplace=True))
            in_ch = item
            if conv_i == target:
                break
            conv_i += 1
        self.features = nn.Sequential(*layers)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self, generator)

    def load_params(self, state_dict: Mapping) -> None:
        """Load a torchvision-named state dict (tensors or numpy arrays):
        a full torchvision VGG's, whose keys beyond this trunk are ignored,
        or :func:`params_from_jax`'s. A missing trunk key raises. An int8
        trunk re-quantises its weights from the loaded float32 values."""
        own = self.state_dict()
        self.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items() if k in own}
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


def init_params(
    cfg_name: str = "vgg16",
    layer_index: int = -1,
    seed: int = 0,
    image_size: int = 224,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """A trunk's float32 state dict, the form :meth:`VGGConvFeatures.load_params`
    takes, drawn as Flax's ``nn.Conv`` draws (lecun-normal kernels, zero
    biases) from ``torch.Generator().manual_seed(seed)``. The values differ
    from the JAX package's draws for the same seed. ``image_size`` and
    ``dtype`` change nothing, as in the JAX package, whose parameters are
    float32 for every compute dtype and input size."""
    gen = torch.Generator().manual_seed(seed)
    return VGGConvFeatures(cfg_name, layer_index, generator=gen).state_dict()


def params_from_jax(params: Mapping, cfg_name: str = "vgg16") -> Dict[str, torch.Tensor]:
    """Convert the JAX package's VGG params to this trunk's ``state_dict``.

    ``params`` is the Flax tree as numpy arrays,
    ``{"params": {"conv{i}": {"kernel": (3, 3, Cin, Cout), "bias": (Cout,)}}}``,
    holding the convs of a trunk truncated anywhere; kernels go from HWIO
    to OIHW, the reverse of the JAX package's
    ``params_from_torch_state_dict``. The keys are torchvision's
    ``features.{i}.weight`` / ``.bias`` for the variant ``cfg_name``.
    """
    tree = params["params"]
    indices = _conv_feature_indices(cfg_name, len(tree) - 1)
    state = {}
    for i, idx in enumerate(indices):
        kernel = np.asarray(tree[f"conv{i}"]["kernel"], np.float32)
        bias = np.asarray(tree[f"conv{i}"]["bias"], np.float32)
        state[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
        )
        state[f"features.{idx}.bias"] = torch.from_numpy(bias.copy())
    return state
