"""ResNet50 trunk with the int8 routing -> VLAD, as the program runs it:
``DeepConvFeature(module=ResNetTrunk("resnet50", int8=True))`` in bfloat16
under ``VLADEncoder``."""
from __future__ import annotations

import math

import torch

from benchmark import images, resnet_roofline

FEATURES = "extract_batch"


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The trunk's float32 state dict, drawn on ``device`` in five calls
    under torchvision's names: lecun-normal kernels (a normal truncated at
    +-2, scaled to variance 1 / fan_in), as ``ResNetTrunk.reset_parameters``
    draws them, and BatchNorm away from identity (weight U(0.5, 1.5), bias
    N(0, 0.1), running mean N(0, 0.1), running variance U(0.5, 2)), so that
    a BatchNorm skipped or misapplied moves the descriptors."""
    convs = resnet_roofline.convs(cfg)
    shapes = [(c["cout"], c["cin"], c["k"], c["k"]) for c in convs]
    gen = images.generator(seed, "weights", device)
    flat = torch.empty(sum(math.prod(s) for s in shapes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    n_bn = sum(c["cout"] for c in convs)
    bn = {"weight": torch.rand(n_bn, generator=gen, device=device) + 0.5,
          "bias": 0.1 * torch.randn(n_bn, generator=gen, device=device),
          "running_mean": 0.1 * torch.randn(n_bn, generator=gen, device=device),
          "running_var": 1.5 * torch.rand(n_bn, generator=gen, device=device) + 0.5}
    state, pos, at = {}, 0, 0
    for c, shape in zip(convs, shapes):
        n = math.prod(shape)
        std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / 0.87962566103423978
        state[f"{c['name']}.weight"] = flat[pos:pos + n].view(shape) * std
        for key, values in bn.items():
            state[f"{c['bn']}.{key}"] = values[at:at + c["cout"]]
        state[f"{c['bn']}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64,
                                                               device=device)
        pos += n
        at += c["cout"]
    return state


def build(cfg: dict, weights: dict, centers: torch.Tensor, device):
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.models.resnet import ResNetTrunk
    from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook

    r = cfg["resnet"]
    trunk = ResNetTrunk(r["cfg_name"], n_stages=r["n_stages"], int8=True,
                        int8_min_spatial=r["int8_min_spatial"],
                        int8_max_spatial=r["int8_max_spatial"])
    ext = DeepConvFeature(module=trunk, params=weights, dtype=torch.bfloat16,
                          image_size=r["image_size"], spatial_encoding=cfg["spatial_encoding"],
                          device=device)
    vlad = cfg["vlad"]
    return VLADEncoder(ext, kmeans_model=KMeansCodebook(centers=centers),
                       power_norm_weight=vlad["power_norm_weight"],
                       norm_order=vlad["norm_order"], epsilon=vlad["epsilon"], device=device)
