"""VGG16 conv trunk with the int8 routing -> VLAD, as the program runs it:
``DeepConvFeature(int8=True)`` in bfloat16 under ``VLADEncoder``."""
from __future__ import annotations

import math

import torch

from benchmark import images

FEATURES = "extract_batch"


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The trunk's float32 state dict, drawn on ``device`` in one call:
    lecun-normal kernels (a normal truncated at +-2, scaled to variance
    1 / fan_in) and zero biases, the program's own initialisation, under
    torchvision's ``features.{i}`` names."""
    trunk = cfg["trunk"]
    shapes, cin = [], 3
    for cout in trunk["widths"]:
        shapes.append((cout, cin, 3, 3))
        cin = cout
    gen = images.generator(seed, "weights", device)
    flat = torch.empty(sum(math.prod(s) for s in shapes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    state, pos, idx = {}, 0, 0
    for i, shape in enumerate(shapes):
        n = math.prod(shape)
        std = math.sqrt(1.0 / (shape[1] * 9)) / 0.87962566103423978
        state[f"features.{idx}.weight"] = flat[pos:pos + n].view(shape) * std
        state[f"features.{idx}.bias"] = torch.zeros(shape[0], device=device)
        pos += n
        idx += 2 + (1 if i in trunk["pools_after"] else 0)
    return state


def build(cfg: dict, weights: dict, centers: torch.Tensor, device):
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook

    trunk = cfg["trunk"]
    ext = DeepConvFeature("vgg16", params=weights, int8=True, dtype=torch.bfloat16,
                          image_size=trunk["image_size"],
                          spatial_encoding=cfg["spatial_encoding"], device=device)
    vlad = cfg["vlad"]
    return VLADEncoder(ext, kmeans_model=KMeansCodebook(centers=centers),
                       power_norm_weight=vlad["power_norm_weight"],
                       norm_order=vlad["norm_order"], epsilon=vlad["epsilon"], device=device)
