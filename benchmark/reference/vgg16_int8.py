"""Plain VGG16 conv trunk with the int8 routing of the configuration.

Each conv runs at the precision the configuration states for it
(``trunk.conv_precision``): bfloat16 convs as a float32 conv (TF32 off) of
bfloat16-rounded maps and weights, plus the bias, ReLU, the pool where one
follows, one rounding to bfloat16; int8 convs by the frozen recipe of
``reference/quant.py``. The weights are the float32 masters the benchmark
drew; the reference forms every int8 weight and scale from them itself.
Preprocessing is the program's documented one: /255, an antialiased
bilinear resize in float32 to the trunk's input size, bfloat16. The
descriptors are the last conv's post-ReLU map, (h, w) row-major, with the
(x / W, y / H) coordinates appended in bfloat16.

``precision`` lowers parts for the control: ``{"bfloat16": "int8"}`` runs
the bfloat16 convs through the int8 recipe, ``{"int8": "int4"}`` the int8
convs with 7 levels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import quant

STATED = {"bfloat16": "bfloat16", "int8": "int8"}
CONTROL = {"bfloat16": "int8", "int8": "int4"}


def _preprocess(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    x = images_u8.to(torch.float32) / 255.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).to(torch.bfloat16)  # NHWC


def _bf16_conv(x, w, b, pool: bool):
    """SAME 3x3 conv of bf16 NHWC ``x`` with ``w (Cout, Cin, 3, 3)``: the
    fused kernel's plain version where a pool follows (float32 bias), else
    cuDNN's bf16 conv (the bias in bf16) and ReLU, one rounding."""
    w_nhwc = w.permute(0, 2, 3, 1)
    if pool:
        return quant.conv3x3_relu_maxpool_reference(x, w_nhwc.to(torch.bfloat16), b)
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    wf = w.to(torch.bfloat16).to(torch.float32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xf, wf, padding=1)
    y = torch.relu(y + b.to(torch.bfloat16).to(torch.float32).view(-1, 1, 1))
    return y.permute(0, 2, 3, 1).to(torch.bfloat16)


def descriptors(cfg: dict, weights: dict, images: np.ndarray, device, precision=None,
                block: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """``(desc (n, Hf * Wf, C + 2) float32, mask (n, Hf * Wf))`` of uint8
    images ``(n, H, W, 3)``, in blocks of ``block`` images."""
    precision = {**STATED, **(precision or {})}
    trunk = cfg["trunk"]
    keys = sorted((k for k in weights if k.endswith(".weight")),
                  key=lambda k: int(k.split(".")[1]))
    out = []
    for start in range(0, len(images), block):
        x = _preprocess(torch.as_tensor(images[start:start + block]).to(device),
                        trunk["image_size"])
        for i, key in enumerate(keys):
            w, b = weights[key], weights[key.replace(".weight", ".bias")]
            pool = i in trunk["pools_after"]
            route = precision[trunk["conv_precision"][i]]
            if route in quant.LEVELS:
                levels = quant.LEVELS[route]
                wq, sw = quant.quantize_weight(w.permute(0, 2, 3, 1), levels)
                x = quant.quant_conv_reference(x, wq, sw, b, relu=True, pool=pool, levels=levels)
            else:
                x = _bf16_conv(x, w, b, pool)
        n, hf, wf, c = x.shape
        desc = x.reshape(n, hf * wf, c)
        if cfg["spatial_encoding"]:
            ys = torch.arange(hf, dtype=torch.bfloat16, device=x.device) / hf
            xs = torch.arange(wf, dtype=torch.bfloat16, device=x.device) / wf
            coords = torch.stack([xs[None, :].expand(hf, wf), ys[:, None].expand(hf, wf)], -1)
            desc = torch.cat([desc, coords.reshape(1, hf * wf, 2).expand(n, -1, -1)], -1)
        out.append(desc.to(torch.float32))
    desc = torch.cat(out)
    return desc, torch.ones(desc.shape[:2], dtype=torch.float32, device=desc.device)
