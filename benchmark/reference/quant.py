"""The int8 recipe of the VGG trunk: the benchmark's reference for it.

A frozen copy, made at commit ede8601, of the plain versions in
``pyvisim_tpu_torch/ops/cuda/conv.py`` (the quantise semantics of
``pyvisim_tpu_torch/models/quant.py:QuantConv``: per-image activation
scales ``max(max|x| / 127, 1e-8)``, per-output-channel weight scales from
the float32 weights, values rounded half to even and clipped, exact int32
sums, then ``float(acc) * (sx * sw) + b`` in float32, ReLU, the 2x2 pool
and one rounding to the input's type), and of the plain version of the
fused bf16 conv (``conv3x3_relu_maxpool_reference``). It imports nothing
of the program.

Changes from the copied text: the number of levels, 127 in the copied
recipe, is ``LEVELS`` of this module's functions' ``levels`` argument, so
that the control can quantise to int4 (7 levels).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LEVELS = {"int8": 127, "int4": 7}


def _scale_shape(t: torch.Tensor) -> tuple:
    return (-1,) + (1,) * (t.dim() - 1)


def _scale_from_amax(amax: torch.Tensor, levels: int = 127) -> torch.Tensor:
    return torch.clamp_min(amax / float(levels), 1e-8)


def activation_scale(x: torch.Tensor, levels: int = 127) -> torch.Tensor:
    """Per-image scales ``max(max|x[b]| / 127, 1e-8)`` in float32, ``(B,)``."""
    amax = torch.linalg.vector_norm(
        x, ord=math.inf, dim=tuple(range(1, x.dim())), dtype=torch.float32
    )
    return _scale_from_amax(amax, levels)


def _quantize(x: torch.Tensor, scale: torch.Tensor, levels: int = 127) -> torch.Tensor:
    q = torch.round(x.to(torch.float32) / scale.view(_scale_shape(x)))
    return q.clamp_(-levels, levels).to(torch.int8)


def quantize_activation(x: torch.Tensor, levels: int = 127):
    """``(xq int8, sx (B,) f32)``: each image on its own scale, so that an
    image's grid never depends on its batchmates."""
    sx = activation_scale(x, levels)
    return _quantize(x, sx, levels), sx


def quantize_weight(w: torch.Tensor, levels: int = 127):
    """``(wq int8, sw (Cout,) f32)`` of a weight whose first dimension is the
    output channel, scaled per output channel from its float32 values."""
    wf = w.to(torch.float32)
    sw = torch.clamp_min(wf.abs().amax(dim=tuple(range(1, w.dim()))) / float(levels), 1e-8)
    return _quantize(wf, sw, levels), sw


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """Flax's SAME padding: the output has ceil(size / stride) positions,
    the odd pixel of padding goes after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _max_pool_2x2(y: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of NHWC ``y``, flooring odd sides (empty below 2)."""
    b, h, w, c = y.shape
    if h < 2 or w < 2:
        return y.new_empty((b, h // 2, w // 2, c))
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _int_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding) -> torch.Tensor:
    """The exact int32 conv of NHWC int8 ``xq`` with ``wq (Cout, kh, kw,
    Cin)``: a float64 conv of the integer values, rounded. Its products and
    sums stay far below 2**53, so every algorithm gives the exact sums, on
    the CPU and on the card."""
    kh, kw = wq.shape[1], wq.shape[2]
    if padding == "SAME":
        pads = (*_same_pads(xq.shape[2], kw, stride), *_same_pads(xq.shape[1], kh, stride))
    elif padding == "VALID":
        pads = (0, 0, 0, 0)
    else:
        ph, pw = (padding, padding) if isinstance(padding, int) else tuple(padding)
        pads = (pw, pw, ph, ph)
    xd = F.pad(xq.permute(0, 3, 1, 2).to(torch.float64), pads)
    acc = F.conv2d(xd, wq.permute(0, 3, 1, 2).to(torch.float64), stride=stride)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1)


def quant_conv_reference(x, wq, sw, b=None, *, stride: int = 1, padding="SAME",
                         relu: bool = False, pool: bool = False, return_acc: bool = False,
                         levels: int = 127):
    """The ``QuantConv`` recipe on NHWC ``x`` with ``wq (Cout, kh, kw, Cin)``
    int8 and ``sw (Cout,)``: quantise ``x`` per image, the exact int32 conv,
    then ``float(acc) * (sx * sw) + b``, ReLU if ``relu``, the 2x2 max-pool
    if ``pool``, and one rounding to ``x.dtype``. ``padding`` is "SAME",
    "VALID", an int or an (h, w) pair. With ``return_acc`` the int32
    accumulators come too."""
    xq, sx = quantize_activation(x, levels)
    acc = _int_conv(xq, wq, stride, padding)
    y = acc.to(torch.float32) * (sx.view(-1, 1, 1, 1) * sw.to(torch.float32))
    if b is not None:
        y = y + b.to(torch.float32)
    if relu:
        y = torch.relu(y)
    if pool:
        y = _max_pool_2x2(y)
    y = y.to(x.dtype).contiguous()
    return (y, acc) if return_acc else y


def conv3x3_relu_maxpool_reference(x, w, b):
    """Plain version of kernel 7, the port of the JAX package's
    ``conv3x3_relu_maxpool_reference``: the SAME conv of ``x`` with
    ``w.to(x.dtype)``, both promoted to float32 (cuDNN's TF32 off), plus the
    float32 bias, ReLU, the 2x2 max-pool, one rounding to ``x.dtype``.
    ``(B, H, W, Cin)`` -> ``(B, H // 2, W // 2, Cout)``."""
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    wf = w.to(x.dtype).to(torch.float32).permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xf, wf, padding=1)
    y = torch.relu(y + b.to(torch.float32).view(-1, 1, 1))
    return _max_pool_2x2(y.permute(0, 2, 3, 1)).to(x.dtype).contiguous()
