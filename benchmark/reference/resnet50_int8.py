"""Plain ResNet50 trunk (arXiv:1512.03385, torchvision's resnet50 widths)
with the int8 routing of the configuration.

The stem (7x7/2 conv, BatchNorm, ReLU, 3x3/2 max pool with padding 1),
then layer1-4 of bottlenecks: 1x1, 3x3 with the stage's stride, 1x1 to
four times the width, each followed by BatchNorm; a projection shortcut
(1x1 conv at the stride, BatchNorm) where the shape changes; the residual
add, then ReLU. Each conv's route is decided here from the map it takes
(``route``: int8 where its side lies in the configuration's routing
window and it has >= 64 channels, bfloat16 otherwise; the stem is
bfloat16), and it runs at the precision the configuration states for that
route: a bfloat16 conv is a float32 conv (TF32 off) of bfloat16-rounded
maps and weights, rounded once to bfloat16; an int8 conv follows the
frozen recipe of ``reference/quant.py`` at its stride and padding.
BatchNorm uses the float32 running statistics, ``(x - mean) / sqrt(var +
1e-5) * weight + bias``, rounded once to bfloat16. Preprocessing is the
program's documented one: /255, an antialiased bilinear resize in float32
to the input size, bfloat16. The descriptors are layer4's map, (h, w)
row-major, with the (x / W, y / H) coordinates appended in bfloat16.

Departures from the published network: no average pool and no fc (the
trunk ends at layer4's map); BatchNorm on running statistics only.

``precision`` lowers parts for the control: ``{"bfloat16": "int8"}`` runs
the bfloat16 convs (the stem too) through the int8 recipe, ``{"int8":
"int4"}`` the int8 convs with 7 levels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import quant
from .vgg16_int8 import _preprocess

STATED = {"bfloat16": "bfloat16", "int8": "int8"}
CONTROL = {"bfloat16": "int8", "int8": "int4"}
EPS = 1e-5


def route(cfg: dict, x: torch.Tensor) -> str:
    """The route of a block conv taking NHWC ``x``."""
    r = cfg["resnet"]
    side, cin = x.shape[1], x.shape[3]
    return "int8" if r["int8_min_spatial"] <= side <= r["int8_max_spatial"] and cin >= 64 \
        else "bfloat16"


def _conv(x, weights: dict, name: str, stride: int, pad: int, prec: str):
    """The conv ``name`` of bfloat16 NHWC ``x`` at precision ``prec``."""
    w = weights[f"{name}.weight"]
    if prec in quant.LEVELS:
        levels = quant.LEVELS[prec]
        wq, sw = quant.quantize_weight(w.permute(0, 2, 3, 1), levels)
        return quant.quant_conv_reference(x, wq, sw, None, stride=stride, padding=pad,
                                          levels=levels)
    y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2),
                 w.to(torch.bfloat16).to(torch.float32), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).to(torch.bfloat16)


def _bn(x, weights: dict, name: str):
    """BatchNorm ``name`` on running statistics, in float32, one rounding."""
    p = {k: weights[f"{name}.{k}"].to(torch.float32)
         for k in ("weight", "bias", "running_mean", "running_var")}
    y = (x.to(torch.float32) - p["running_mean"]) * torch.rsqrt(p["running_var"] + EPS)
    return (y * p["weight"] + p["bias"]).to(torch.bfloat16)


def _shortcut(x, weights: dict, pre: str, stride: int, cfg: dict, precision: dict):
    """The block's shortcut: the projection where it has one, else ``x``."""
    if f"{pre}.downsample.0.weight" not in weights:
        return x
    y = _conv(x, weights, f"{pre}.downsample.0", stride, 0, precision[route(cfg, x)])
    return _bn(y, weights, f"{pre}.downsample.1")


def _bottleneck(x, weights: dict, pre: str, stride: int, cfg: dict, precision: dict):
    y = torch.relu(_bn(_conv(x, weights, f"{pre}.conv1", 1, 0, precision[route(cfg, x)]),
                       weights, f"{pre}.bn1"))
    y = torch.relu(_bn(_conv(y, weights, f"{pre}.conv2", stride, 1, precision[route(cfg, y)]),
                       weights, f"{pre}.bn2"))
    y = _bn(_conv(y, weights, f"{pre}.conv3", 1, 0, precision[route(cfg, y)]),
            weights, f"{pre}.bn3")
    s = _shortcut(x, weights, pre, stride, cfg, precision)
    return torch.relu((y.to(torch.float32) + s.to(torch.float32)).to(torch.bfloat16))


def trunk(cfg: dict, weights: dict, x: torch.Tensor, precision: dict) -> torch.Tensor:
    """Preprocessed bfloat16 NHWC ``x`` -> layer4's bfloat16 NHWC map."""
    r = cfg["resnet"]
    x = torch.relu(_bn(_conv(x, weights, "conv1", 2, 3, precision["bfloat16"]), weights, "bn1"))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
    for s in range(r["n_stages"]):
        for b in range(r["blocks"][s]):
            x = _bottleneck(x, weights, f"layer{s + 1}.{b}", 2 if s > 0 and b == 0 else 1,
                            cfg, precision)
    return x


def descriptors(cfg: dict, weights: dict, images: np.ndarray, device, precision=None,
                block: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """``(desc (n, Hf * Wf, C + 2) float32, mask (n, Hf * Wf))`` of uint8
    images ``(n, H, W, 3)``, in blocks of ``block`` images, with TF32 off."""
    precision = {**STATED, **(precision or {})}
    out = []
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for start in range(0, len(images), block):
                x = _preprocess(torch.as_tensor(images[start:start + block]).to(device),
                                cfg["resnet"]["image_size"])
                x = trunk(cfg, weights, x, precision)
                n, hf, wf, c = x.shape
                desc = x.reshape(n, hf * wf, c)
                if cfg["spatial_encoding"]:
                    ys = torch.arange(hf, dtype=torch.bfloat16, device=x.device) / hf
                    xs = torch.arange(wf, dtype=torch.bfloat16, device=x.device) / wf
                    coords = torch.stack([xs[None, :].expand(hf, wf),
                                          ys[:, None].expand(hf, wf)], -1)
                    desc = torch.cat([desc, coords.reshape(1, hf * wf, 2).expand(n, -1, -1)], -1)
                out.append(desc.to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    desc = torch.cat(out)
    return desc, torch.ones(desc.shape[:2], dtype=torch.float32, device=desc.device)
