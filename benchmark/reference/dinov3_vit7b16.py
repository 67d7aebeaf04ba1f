"""Plain DINOv3 ViT (arXiv:2508.10104) to the final norm of its patch
tokens (``x_norm_patchtokens``): ViT-7B/16 with 4 register tokens and
axial 2-D RoPE.

The patch embedding (a 16x16 conv at stride 16), the CLS token and the
register ("storage") tokens in front, no position embedding; every block
pre-norm, ``x + ls1.gamma * attn(norm1(x))`` then ``x + ls2.gamma *
ffn(norm2(x))``, with LayerNorm eps 1e-5, the qkv projection biased or not
as the configuration says, a biased output projection, the heads' softmax
attention at scale ``head_dim ** -0.5`` over q and k rotated by RoPE, and
the SwiGLU FFN (``w12`` to two halves, ``silu(x1) * x2``, ``w3``); then the
final LayerNorm of the patch rows, CLS and registers dropped.

RoPE, from its closed form (DINOv3's ``RopePositionEmbedding`` and
``rope_apply``, computed here from the configuration alone): patch centres
``c = 2 (i + 0.5) / g - 1`` on each axis of the ``g x g`` grid (y by rows,
x by columns), ``periods = base ** (2 k / (hd / 2))`` for ``k < hd / 4``,
``angles = 2 pi c / periods``, the y angles then the x angles, tiled twice
to ``hd``; ``q' = q cos + rotate_half(q) sin`` with ``rotate_half(x) =
[-x2, x1]``, k likewise, over the patch rows only.

Computed image by image (32 x 2,309^2 float32 scores an image), in float32
with TF32 off, rounded where the configuration states bfloat16: the
weights, and each map between ops (linears with their bias, the LayerNorms,
q and k after their rotation, the attention output, SiLU's output and its
product with the other half, each LayerScale plus residual add) rounded
once, and the unnormalised softmax weights rounded for their product with
v, as fused attention and the program compute them; the RoPE table, the
rotation, the scores, their max and sum and the LayerNorm statistics stay
float32. Preprocessing is the program's documented one: /255, an
antialiased bilinear resize in float32, bfloat16. It reads the benchmark's
weights under the port's names and imports nothing of the program.

Departures from the published model, each deliberate:
- no ImageNet mean/std normalisation of the input (the program's
  documented preprocessing, as in the other cells): an affine map of the
  input, which random weights absorb;
- DINOv3's ``mlp.w1`` and ``mlp.w2`` held stacked as one ``mlp.w12``: the
  same products, one launch;
- fused attention's arithmetic written out (float32 scores, max and sum;
  bfloat16 weights for the product with v), where DINOv3 calls
  ``scaled_dot_product_attention``;
- the encodings use the port's VLAD normalisation (``reference/vlad.py``:
  power norm, per-cluster L2 with an additive epsilon) in place of
  AnyLoc's intra-normalisation and descriptor L2.

``precision`` lowers parts for the control: ``{"bfloat16": "int8"}`` runs
every linear and the patch projection through the int8 recipe of
``reference/quant.py`` (per-image activation scales, per-output-channel
weight scales, exact integer sums); RoPE, attention, LayerNorm and the adds
stay as stated.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import quant
from .vgg16_int8 import _preprocess

STATED = {"bfloat16": "bfloat16"}
CONTROL = {"bfloat16": "int8"}


def _w(t: torch.Tensor) -> torch.Tensor:
    """A parameter as stated: rounded to bfloat16, computed in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _bias(weights: dict, name: str):
    b = weights.get(f"{name}.bias")
    return None if b is None else _w(b)


def _linear(x, weights: dict, name: str, prec: str):
    """``x @ W.T (+ b)`` of the linear ``name`` on bfloat16 ``(n, N, Din)``
    ``x``, rounded once to bfloat16."""
    w, b = weights[f"{name}.weight"], _bias(weights, name)
    if prec in quant.LEVELS:
        levels = quant.LEVELS[prec]
        xq, sx = quant.quantize_activation(x, levels)
        wq, sw = quant.quantize_weight(w, levels)
        acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64).T)
        y = acc.to(torch.float32) * (sx.view(-1, 1, 1) * sw)
        return (y if b is None else y + b).to(torch.bfloat16)
    return F.linear(x.to(torch.float32), _w(w), b).to(torch.bfloat16)


def _layer_norm(x, weights: dict, name: str, cfg: dict):
    y = F.layer_norm(x.to(torch.float32), (x.shape[-1],), _w(weights[f"{name}.weight"]),
                     _w(weights[f"{name}.bias"]), eps=cfg["dinov3"]["layer_norm_eps"])
    return y.to(torch.bfloat16)


def rope_sin_cos(cfg: dict, gh: int, gw: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sin, cos)``, each ``(gh * gw, hd)`` float32, of the patches of a
    ``gh x gw`` grid in row-major order, from the closed form."""
    v = cfg["dinov3"]
    hd = v["head_dim"]
    dd = {"device": device, "dtype": torch.float32}
    periods = v["rope_base"] ** (2 * torch.arange(hd // 4, **dd) / (hd // 2))
    coords_h = torch.arange(0.5, gh, **dd) / gh
    coords_w = torch.arange(0.5, gw, **dd) / gw
    coords = torch.stack(torch.meshgrid(coords_h, coords_w, indexing="ij"), dim=-1).flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = angles.flatten(1, 2).tile(2)
    return torch.sin(angles), torch.cos(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """float32 ``(n, H, N, hd)`` heads with their last ``P`` rows rotated by
    ``(P, hd)`` ``sin`` and ``cos``, rounded once to bfloat16."""
    p = x.shape[-2] - sin.shape[0]
    rotated = x[:, :, p:] * cos + _rotate_half(x[:, :, p:]) * sin
    return torch.cat([x[:, :, :p], rotated], dim=2).to(torch.bfloat16).to(torch.float32)


def _scale(head_dim: int) -> float:
    return head_dim ** -0.5


def _attention(x, weights: dict, pre: str, cfg: dict, prec: str, rope):
    """The attention branch of block ``pre`` on normed bfloat16 ``x``."""
    n, t, d = x.shape
    heads = cfg["dinov3"]["num_heads"]
    qkv = _linear(x, weights, f"{pre}.attn.qkv", prec).to(torch.float32)
    q, k, v = qkv.view(n, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    q, k = _rope(q, *rope), _rope(k, *rope)
    s = torch.matmul(q, k.transpose(-2, -1)) * _scale(d // heads)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (torch.matmul(_w(e), v) / e.sum(-1, keepdim=True)).to(torch.bfloat16)
    return _linear(o.transpose(1, 2).reshape(n, t, d), weights, f"{pre}.attn.proj", prec)


def _ffn(x, weights: dict, pre: str, prec: str):
    """The SwiGLU branch of block ``pre`` on normed bfloat16 ``x``."""
    x1, x2 = _linear(x, weights, f"{pre}.mlp.w12", prec).to(torch.float32).chunk(2, dim=-1)
    h = _w(F.silu(x1)) * x2
    return _linear(h.to(torch.bfloat16), weights, f"{pre}.mlp.w3", prec)


def _residual(x, y, gamma):
    """``x + gamma * y`` in float32, one rounding."""
    return (x.to(torch.float32) + _w(gamma) * y.to(torch.float32)).to(torch.bfloat16)


def _block(x, weights: dict, i: int, cfg: dict, prec: str, rope):
    pre = f"blocks.{i}"
    y = _attention(_layer_norm(x, weights, f"{pre}.norm1", cfg), weights, pre, cfg, prec, rope)
    x = _residual(x, y, weights[f"{pre}.ls1.gamma"])
    y = _ffn(_layer_norm(x, weights, f"{pre}.norm2", cfg), weights, pre, prec)
    return _residual(x, y, weights[f"{pre}.ls2.gamma"])


def _embed(x, weights: dict, cfg: dict, prec: str):
    """Preprocessed bfloat16 NHWC ``x`` -> ``(n, 1 + R + gh gw, d)`` tokens:
    CLS, the registers, the patches."""
    w, b = weights["patch_embed.proj.weight"], weights["patch_embed.proj.bias"]
    p = cfg["dinov3"]["patch_size"]
    if prec in quant.LEVELS:
        levels = quant.LEVELS[prec]
        wq, sw = quant.quantize_weight(w.permute(0, 2, 3, 1), levels)
        y = quant.quant_conv_reference(x, wq, sw, _w(b), stride=p, padding="VALID",
                                       levels=levels)
    else:
        y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), _w(w), _w(b), stride=p)
        y = y.permute(0, 2, 3, 1).to(torch.bfloat16)
    n, d = y.shape[0], y.shape[-1]
    prefix = [_w(weights["cls_token"]).expand(n, 1, d)]
    if "storage_tokens" in weights:
        prefix.append(_w(weights["storage_tokens"]).expand(n, -1, d))
    return torch.cat([*prefix, y.reshape(n, -1, d).to(torch.float32)], dim=1).to(torch.bfloat16)


def trunk(cfg: dict, weights: dict, x: torch.Tensor, precision: dict) -> torch.Tensor:
    """Preprocessed bfloat16 NHWC ``x`` -> the final norm's ``(n, gh gw, d)``
    bfloat16 patch descriptors."""
    v, prec = cfg["dinov3"], precision["bfloat16"]
    p = v["patch_size"]
    rope = rope_sin_cos(cfg, x.shape[1] // p, x.shape[2] // p, x.device)
    t = _embed(x, weights, cfg, prec)
    for i in range(v["depth"]):
        t = _block(t, weights, i, cfg, prec, rope)
    return _layer_norm(t[:, t.shape[1] - rope[0].shape[0]:], weights, "norm", cfg)


def descriptors(cfg: dict, weights: dict, images: np.ndarray, device, precision=None,
                block: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """``(desc (n, gh gw, d) float32, mask (n, gh gw))`` of uint8 images
    ``(n, H, W, 3)``, in blocks of ``block`` images, with TF32 off."""
    precision = {**STATED, **(precision or {})}
    out = []
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for start in range(0, len(images), block):
                x = _preprocess(torch.as_tensor(images[start:start + block]).to(device),
                                cfg["dinov3"]["image_size"])
                out.append(trunk(cfg, weights, x, precision).to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    desc = torch.cat(out)
    return desc, torch.ones(desc.shape[:2], dtype=torch.float32, device=desc.device)
