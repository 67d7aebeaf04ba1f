"""Plain DINOv2 ViT (arXiv:2304.07193) to one block's facet, the local
descriptor of AnyLoc (arXiv:2308.00688): ViT-g/14's block 31, value facet.

The patch embedding (a 14x14 conv at stride 14), the CLS token in front,
the position embedding added; blocks ``0 .. layer-1``, each pre-norm
``x + ls1.gamma * attn(norm1(x))`` then ``x + ls2.gamma * ffn(norm2(x))``
with LayerNorm eps 1e-6, biased qkv and output projections, the heads'
softmax attention at scale ``head_dim ** -0.5``, and the FFN of the
configuration (SwiGLU: ``w12`` to two halves, ``silu(x1) * x2``, ``w3``;
or GELU between ``fc1`` and ``fc2``); then block ``layer``'s facet: the
query, key or value third of ``qkv`` on ``norm1`` of the patch tokens, or
the whole block's output (``token``); the CLS token dropped. Computed
image by image (24 x 1,370^2 float32 scores an image), in float32 with
TF32 off, rounded where the configuration states bfloat16: the weights,
and each map between ops (linears with their bias, the LayerNorms, the
attention output, SiLU's output and its product with the other half, or
GELU's output, each LayerScale plus residual add) rounded once, and the
unnormalised softmax weights rounded for their product with v, as
DINOv2's fused attention (xFormers) and the program's compute them; the
scores, their max and sum, and the LayerNorm statistics stay float32.
Preprocessing is the program's documented one: /255, an antialiased
bilinear resize in float32, bfloat16. It reads the benchmark's weights
under DINOv2's names and imports nothing of the program.

Departures from the published model, each deliberate:
- no ImageNet mean/std normalisation of the input (the program's
  documented preprocessing, as in the other cells): an affine map of the
  input, which random weights absorb;
- the position embedding at its native grid only (518^2, 37 x 37): DINOv2
  interpolates it for other sizes, the port refuses them;
- xFormers' memory-efficient attention written out as its arithmetic
  (float32 scores, max and sum; bfloat16 weights for the product with v);
- the encodings use the port's VLAD normalisation (``reference/vlad.py``:
  power norm, per-cluster L2 with an additive epsilon) in place of
  AnyLoc's intra-normalisation and descriptor L2.

``precision`` lowers parts for the control: ``{"bfloat16": "int8"}`` runs
every linear and the patch projection through the int8 recipe of
``reference/quant.py`` (per-image activation scales, per-output-channel
weight scales, exact integer sums); attention, LayerNorm and the adds stay
as stated.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import quant
from .vgg16_int8 import _preprocess

STATED = {"bfloat16": "bfloat16"}
CONTROL = {"bfloat16": "int8"}
FACETS = ("query", "key", "value", "token")
EPS = 1e-6


def _w(t: torch.Tensor) -> torch.Tensor:
    """A parameter as stated: rounded to bfloat16, computed in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _linear(x, weights: dict, name: str, prec: str, rows: slice = slice(None)):
    """``x @ W.T + b`` of the linear ``name`` (its output ``rows`` only) on
    bfloat16 ``(n, N, Din)`` ``x``, rounded once to bfloat16."""
    w, b = weights[f"{name}.weight"][rows], weights[f"{name}.bias"][rows]
    if prec in quant.LEVELS:
        levels = quant.LEVELS[prec]
        xq, sx = quant.quantize_activation(x, levels)
        wq, sw = quant.quantize_weight(w, levels)
        acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64).T)
        y = acc.to(torch.float32) * (sx.view(-1, 1, 1) * sw) + _w(b)
        return y.to(torch.bfloat16)
    return F.linear(x.to(torch.float32), _w(w), _w(b)).to(torch.bfloat16)


def _layer_norm(x, weights: dict, name: str):
    y = F.layer_norm(x.to(torch.float32), (x.shape[-1],), _w(weights[f"{name}.weight"]),
                     _w(weights[f"{name}.bias"]), eps=EPS)
    return y.to(torch.bfloat16)


def _scale(head_dim: int) -> float:
    return head_dim ** -0.5


def _attention(x, weights: dict, pre: str, cfg: dict, prec: str):
    """The attention branch of block ``pre`` on normed bfloat16 ``x``."""
    n, t, d = x.shape
    heads = cfg["vit"]["num_heads"]
    qkv = _linear(x, weights, f"{pre}.attn.qkv", prec).to(torch.float32)
    q, k, v = qkv.view(n, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-2, -1)) * _scale(d // heads)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (torch.matmul(_w(e), v) / e.sum(-1, keepdim=True)).to(torch.bfloat16)
    return _linear(o.transpose(1, 2).reshape(n, t, d), weights, f"{pre}.attn.proj", prec)


def _ffn(x, weights: dict, pre: str, cfg: dict, prec: str):
    """The FFN branch of block ``pre`` on normed bfloat16 ``x``."""
    if cfg["vit"]["ffn"] == "swiglu":
        x1, x2 = _linear(x, weights, f"{pre}.mlp.w12", prec).to(torch.float32).chunk(2, dim=-1)
        h = _w(F.silu(x1)) * x2
        return _linear(h.to(torch.bfloat16), weights, f"{pre}.mlp.w3", prec)
    h = F.gelu(_linear(x, weights, f"{pre}.mlp.fc1", prec).to(torch.float32))
    return _linear(h.to(torch.bfloat16), weights, f"{pre}.mlp.fc2", prec)


def _residual(x, y, gamma):
    """``x + gamma * y`` in float32, one rounding."""
    return (x.to(torch.float32) + _w(gamma) * y.to(torch.float32)).to(torch.bfloat16)


def _block(x, weights: dict, i: int, cfg: dict, prec: str):
    pre = f"blocks.{i}"
    y = _attention(_layer_norm(x, weights, f"{pre}.norm1"), weights, pre, cfg, prec)
    x = _residual(x, y, weights[f"{pre}.ls1.gamma"])
    y = _ffn(_layer_norm(x, weights, f"{pre}.norm2"), weights, pre, cfg, prec)
    return _residual(x, y, weights[f"{pre}.ls2.gamma"])


def _embed(x, weights: dict, cfg: dict, prec: str):
    """Preprocessed bfloat16 NHWC ``x`` -> ``(n, 1 + g^2, d)`` tokens."""
    w, b = weights["patch_embed.proj.weight"], weights["patch_embed.proj.bias"]
    p = cfg["vit"]["patch_size"]
    if prec in quant.LEVELS:
        levels = quant.LEVELS[prec]
        wq, sw = quant.quantize_weight(w.permute(0, 2, 3, 1), levels)
        y = quant.quant_conv_reference(x, wq, sw, _w(b), stride=p, padding="VALID",
                                       levels=levels)
    else:
        y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), _w(w), _w(b), stride=p)
        y = y.permute(0, 2, 3, 1).to(torch.bfloat16)
    n, d = y.shape[0], y.shape[-1]
    cls = _w(weights["cls_token"]).expand(n, 1, d)
    t = torch.cat([cls, y.reshape(n, -1, d).to(torch.float32)], dim=1) + _w(weights["pos_embed"])
    return t.to(torch.bfloat16)


def trunk(cfg: dict, weights: dict, x: torch.Tensor, precision: dict) -> torch.Tensor:
    """Preprocessed bfloat16 NHWC ``x`` -> the facet's ``(n, g^2, d)``
    bfloat16 patch descriptors."""
    v, prec = cfg["vit"], precision["bfloat16"]
    t = _embed(x, weights, cfg, prec)
    for i in range(v["layer"]):
        t = _block(t, weights, i, cfg, prec)
    if v["facet"] == "token":
        return _block(t, weights, v["layer"], cfg, prec)[:, 1:]
    j, d = FACETS.index(v["facet"]), v["embed_dim"]
    pre = f"blocks.{v['layer']}"
    y = _layer_norm(t[:, 1:], weights, f"{pre}.norm1")
    return _linear(y, weights, f"{pre}.attn.qkv", prec, slice(j * d, (j + 1) * d))


def descriptors(cfg: dict, weights: dict, images: np.ndarray, device, precision=None,
                block: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """``(desc (n, g^2, d) float32, mask (n, g^2))`` of uint8 images ``(n,
    H, W, 3)``, in blocks of ``block`` images, with TF32 off."""
    precision = {**STATED, **(precision or {})}
    out = []
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for start in range(0, len(images), block):
                x = _preprocess(torch.as_tensor(images[start:start + block]).to(device),
                                cfg["vit"]["image_size"])
                out.append(trunk(cfg, weights, x, precision).to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    desc = torch.cat(out)
    return desc, torch.ones(desc.shape[:2], dtype=torch.float32, device=desc.device)
