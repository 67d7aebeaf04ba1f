"""VGG convolutional trunks in PyTorch (the deep feature extractor's backbone).

Port of ``pyvisim_tpu/models/vgg.py``: the conv/ReLU/pool trunk truncated
at a chosen conv layer, returning that layer's **post-ReLU** output, which
is what the reference's forward hook observably reads under torchvision's
in-place ReLU.

The trunk is an ``nn.Sequential`` named ``features`` with torchvision's
layer indices (conv, ReLU, pool), so a torchvision VGG ``state_dict``
loads into it as it is. Weights from the JAX package cross through
:func:`params_from_jax`.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

__all__ = [
    "VGG_CFGS",
    "VGGConvFeatures",
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
    ):
        super().__init__()
        if int8:
            raise NotImplementedError(
                "The int8 VGG trunk is not ported to PyTorch yet; use float32 or bfloat16."
            )
        n_convs = num_conv_layers(cfg_name)
        if not -n_convs <= layer_index < n_convs:
            raise IndexError(
                f"Model {cfg_name} has only {n_convs} convolutional layers. "
                f"Got layer_index={layer_index}."
            )
        self.cfg_name = cfg_name
        self.layer_index = layer_index
        target = layer_index % n_convs
        layers, in_ch, conv_i = [], 3, 0
        for item in VGG_CFGS[cfg_name]:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers.append(nn.Conv2d(in_ch, item, 3, padding=1))
            layers.append(nn.ReLU(inplace=True))
            in_ch = item
            if conv_i == target:
                break
            conv_i += 1
        self.features = nn.Sequential(*layers)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                # Flax lecun_normal: variance 1/fan_in after truncation at +-2 std.
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()

    def load_params(self, state_dict: Mapping) -> None:
        """Load a torchvision-named state dict (tensors or numpy arrays):
        a full torchvision VGG's, whose keys beyond this trunk are ignored,
        or :func:`params_from_jax`'s. A missing trunk key raises."""
        own = self.state_dict()
        self.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items() if k in own}
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


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
