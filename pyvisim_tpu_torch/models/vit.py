"""DINOv2 Vision Transformer trunks (ViT-S/B/L/g, patch 14) in PyTorch.

The blocks of DINOv2 (Oquab et al., arXiv:2304.07193), run to one block's
facet and returned as a patch grid, for use as
``DeepConvFeature(module=ViTTrunk(...))``. This is how AnyLoc (Keetha et
al., arXiv:2308.00688) takes its local features: the value facet of ViT-g/14's
block 31, with the CLS token dropped.

A forward takes ``(B, 3, S, S)`` (channels-last strides accepted) with
``S`` the trunk's ``image_size`` and runs, with DINOv2's names:

- ``patch_embed.proj``, a 14x14 conv at stride 14, to ``(S/14)^2`` tokens;
  ``cls_token`` in front; ``pos_embed`` (fixed grid, no interpolation)
  added;
- blocks ``0 .. layer-1``, each pre-norm with LayerScale on both branches:
  ``x + ls1.gamma * attn(norm1(x))``, then ``x + ls2.gamma * mlp(norm2(x))``
  (LayerNorm eps 1e-6; biases on ``attn.qkv``, ``attn.proj`` and the FFN);
  the FFN is GELU (``mlp.fc1``, ``mlp.fc2``) in ViT-S/B/L and SwiGLU
  (``mlp.w12`` to two halves, ``silu(x1) * x2``, ``mlp.w3``) in ViT-g;
- the facet of block ``layer``: ``"query"``, ``"key"`` or ``"value"`` is
  that third of ``attn.qkv`` applied to ``norm1`` of the patch tokens (the
  rest of the block is not run); ``"token"`` is the whole block's output;
- the CLS token dropped, ``(B, C, S/14, S/14)`` returned.

The trunk holds blocks ``0 .. layer`` only, so a DINOv2 state dict cut to
those blocks (without ``mask_token`` and ``norm``) loads as it is.

Attention's route is decided by the trunk on each call
(:func:`attention_route`): bf16 or fp16 on CUDA runs cuDNN's fused
flash-type attention, and only that (``sdpa_kernel`` with the one
backend, which raises rather than falls back; on an H100 at the ViT-g
cell's 64 x 24 heads x 1,370 tokens x 64 it took 1.95 ms a call against
FlashAttention-2's 2.60); anything else (the CPU, float32) runs
:func:`attention_reference`, the plain math in the fused kernel's
arithmetic.

The float passes between a block's linears take a route of the same kind,
decided from the map (``ops/cuda/vit_passes.py:takes``): bf16 maps on CUDA
whose width is a multiple of 8 run two hand-written kernels, SwiGLU in one
pass over ``w12``'s output, and each LayerScale + residual add together
with the LayerNorm that follows it (``ls1`` with ``norm2``, ``ls2`` with
the next block's ``norm1``; the trunk hands the normed map on, so only
block 0's ``norm1`` is a LayerNorm of its own); anything else runs their
plain versions, the torch passes ``F.silu(x1) * x2``, ``torch.addcmul``
and ``F.layer_norm``. A block called alone (:meth:`Block.forward`) takes
the same passes and ends with its ``ls2`` add.

Under ``profiling.record()`` the trunk opens the spans ``vit.embed``,
``vit.blocks`` (and in each block ``vit.attention`` and ``vit.ffn``) and
``vit.facet``, and counts ``attn.<route>`` (one a block's attention call),
``vit.swiglu.<route>`` and ``vit.add_norm.<route>`` (one a pass, route
``kernel`` or ``plain``) and ``vit.tokens`` (the tokens a forward carries
through the blocks).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..ops.cuda import vit_passes

__all__ = ["ViTTrunk", "ViTSpec", "VARIANTS", "FACETS", "attention_route", "attention_reference"]

PATCH = 14
LN_EPS = 1e-6
FACETS = ("query", "key", "value", "token")
FUSED_ROUTE = "cudnn"


@dataclass(frozen=True)
class ViTSpec:
    """The widths of a ViT: ``ffn`` is ``"mlp"`` (GELU) or ``"swiglu"``,
    ``ffn_hidden`` the width between the FFN's two linears."""

    embed_dim: int
    depth: int
    num_heads: int
    ffn: str
    ffn_hidden: int


# DINOv2's published variants (its hub models, patch 14, 518^2 position grid).
# ViT-g's SwiGLUFFNFused: (int(4 * 1536 * 2 / 3) + 7) // 8 * 8 = 4,096.
VARIANTS = {
    "dinov2_vits14": ViTSpec(384, 12, 6, "mlp", 1536),
    "dinov2_vitb14": ViTSpec(768, 12, 12, "mlp", 3072),
    "dinov2_vitl14": ViTSpec(1024, 24, 16, "mlp", 4096),
    "dinov2_vitg14": ViTSpec(1536, 40, 24, "swiglu", 4096),
}


def attention_route(q: torch.Tensor) -> str:
    """The route of attention over ``q``: the fused kernel for bf16 or fp16
    on CUDA, the plain math otherwise."""
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16):
        return FUSED_ROUTE
    return "math"


def attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` over ``(B, H, N, hd)`` in the fused
    kernels' arithmetic: the scores, their max and the sum of their
    exponentials in float32 (float64 stays float64), the unnormalised
    weights rounded to ``q.dtype`` for their product with ``v``, the
    output divided by the sum and rounded once to ``q.dtype``. In float32
    this is the plain softmax."""
    work = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(work), k.to(work).transpose(-2, -1)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(e.to(q.dtype).to(work), v.to(work)) / e.sum(-1, keepdim=True)
    return o.to(q.dtype)


class LayerScale(nn.Module):
    """DINOv2's ``ls1`` / ``ls2``: ``gamma``, which :class:`Block` applies
    together with the residual add."""

    def __init__(self, dim: int, **factory):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, **factory))


class Attention(nn.Module):
    """Multi-head self-attention with DINOv2's ``qkv`` (q, k, v thirds, each
    head's columns together) and ``proj``."""

    def __init__(self, dim: int, num_heads: int, **factory):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, **factory)
        self.proj = nn.Linear(dim, dim, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4)
        o = self.core(qkv[0], qkv[1], qkv[2])
        return self.proj(o.transpose(1, 2).reshape(b, n, c))

    def core(self, q, k, v) -> torch.Tensor:
        """Attention of ``(B, H, N, hd)`` heads, by the route the trunk takes."""
        route = attention_route(q)
        profiling.count(f"attn.{route}", 1)
        if route == "math":
            return attention_reference(q, k, v, self.scale)
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, scale=self.scale)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, **factory):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, **factory)
        self.fc2 = nn.Linear(hidden, dim, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def _route(x: torch.Tensor, width: int) -> str:
    return "kernel" if vit_passes.takes(x, width) else "plain"


def swiglu(x12: torch.Tensor) -> torch.Tensor:
    """``silu(x1) * x2`` of the halves of ``w12``'s output, by its route."""
    route = _route(x12, x12.shape[-1] // 2)
    profiling.count(f"vit.swiglu.{route}", 1)
    if route == "kernel":
        return vit_passes.swiglu(x12)
    return vit_passes.swiglu_reference(x12)


def add_norm(x: torch.Tensor, y: torch.Tensor, ls: LayerScale, norm: nn.LayerNorm):
    """``(x + ls.gamma * y, norm of it)``, by its route."""
    route = _route(x, x.shape[-1])
    profiling.count(f"vit.add_norm.{route}", 1)
    fn = vit_passes.add_norm if route == "kernel" else vit_passes.add_norm_reference
    return fn(x, y, ls.gamma, norm.weight, norm.bias, norm.eps)


class SwiGLUFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, **factory):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden, **factory)
        self.w3 = nn.Linear(hidden, dim, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(swiglu(self.w12(x)))


class Block(nn.Module):
    def __init__(self, spec: ViTSpec, **factory):
        super().__init__()
        dim = spec.embed_dim
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, **factory)
        self.attn = Attention(dim, spec.num_heads, **factory)
        self.ls1 = LayerScale(dim, **factory)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, **factory)
        ffn = SwiGLUFFN if spec.ffn == "swiglu" else Mlp
        self.mlp = ffn(dim, spec.ffn_hidden, **factory)
        self.ls2 = LayerScale(dim, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x, self.norm1(x))[0]

    def run(self, x: torch.Tensor, h: torch.Tensor, next_norm: nn.LayerNorm | None = None):
        """The block on ``x`` and ``h = norm1(x)``: ``(out, next_norm(out))``,
        or ``(out, None)`` without ``next_norm``."""
        with profiling.span("vit.attention"):
            x, h = add_norm(x, self.attn(h), self.ls1, self.norm2)
        with profiling.span("vit.ffn"):
            y = self.mlp(h)
            if next_norm is None:
                # LayerScale and the residual add in one pass, one rounding.
                return torch.addcmul(x, y, self.ls2.gamma), None
            return add_norm(x, y, self.ls2, next_norm)


class ViTTrunk(nn.Module):
    """A DINOv2 ViT run to one block's facet: ``(B, 3, S, S) -> (B, C, S/14,
    S/14)`` (see the module docstring).

    :param variant: a name of :data:`VARIANTS` or a :class:`ViTSpec`.
    :param layer: the block whose facet is returned (negative from the end
        of ``depth``; default the last).
    :param facet: ``"value"``, ``"key"``, ``"query"`` or ``"token"``.
    :param image_size: the input side, a multiple of 14; it fixes the
        position grid (DINOv2's is 518, 37 x 37).
    :param device, dtype: where and in what the parameters are made.

    The parameters start at DINOv2's initialisation (truncated normal
    linears, patch projection and position embedding, std 0.02; zero
    biases; unit LayerNorms; LayerScale 1e-5), drawn from seed 0.
    """

    def __init__(self, variant: str | ViTSpec = "dinov2_vitg14", layer: int = -1,
                 facet: str = "value", image_size: int = 518, device=None, dtype=None):
        super().__init__()
        if isinstance(variant, str):
            if variant not in VARIANTS:
                raise ValueError(f"Unknown ViT variant {variant!r}; one of {sorted(VARIANTS)}")
            variant = VARIANTS[variant]
        if facet not in FACETS:
            raise ValueError(f"facet must be one of {FACETS}, got {facet!r}")
        if not -variant.depth <= layer < variant.depth:
            raise ValueError(f"layer must lie in [-{variant.depth}, {variant.depth}), got {layer}")
        if image_size % PATCH:
            raise ValueError(f"image_size must be a multiple of {PATCH}, got {image_size}")
        self.spec, self.facet, self.image_size = variant, facet, image_size
        self.layer = layer % variant.depth
        self.grid = image_size // PATCH
        factory = {"device": device, "dtype": dtype}
        dim = variant.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, PATCH, PATCH, **factory)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **factory))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + self.grid ** 2, dim, **factory))
        self.blocks = nn.ModuleList(Block(variant, **factory) for _ in range(self.layer + 1))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        if self.cls_token.is_meta:
            return
        generator = torch.Generator(self.cls_token.device).manual_seed(0)

        def draw(t: torch.Tensor, std: float, truncated: bool = True) -> None:
            # Drawn in float32 and copied, whatever the parameter's dtype.
            f = torch.empty(t.shape, device=t.device)
            if truncated:
                nn.init.trunc_normal_(f, std=std, generator=generator)  # timm's: cut at +-2
            else:
                nn.init.normal_(f, std=std, generator=generator)
            t.copy_(f)

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                draw(m.weight, 0.02)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(1e-5)
        draw(self.pos_embed, 0.02)
        draw(self.cls_token, 1e-6, truncated=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(f"ViTTrunk takes {self.image_size}^2 images (its position grid), "
                             f"got {h}x{w}")
        with profiling.span("vit.embed"):
            t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            t = torch.cat([self.cls_token.expand(b, -1, -1), t], dim=1) + self.pos_embed
        profiling.count("vit.tokens", t.shape[0] * t.shape[1])
        blocks = self.blocks
        with profiling.span("vit.blocks"):
            h = blocks[0].norm1(t)
            for i in range(self.layer):
                t, h = blocks[i].run(t, h, blocks[i + 1].norm1)
        with profiling.span("vit.facet"):
            return self._facet(t, h)

    def _facet(self, t: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """Block ``layer``'s facet of the patch tokens as ``(B, C, g, g)``,
        from its input ``t`` and ``h = norm1(t)``. A ``qkv`` third runs over
        every token, the CLS row dropped after it (LayerNorm and the linear
        act token by token), so no strided copy of the patch rows is made."""
        blk = self.blocks[self.layer]
        if self.facet == "token":
            y = blk.run(t, h)[0]
        else:
            d, j = self.spec.embed_dim, FACETS.index(self.facet)
            cols = slice(j * d, (j + 1) * d)
            y = F.linear(h, blk.attn.qkv.weight[cols], blk.attn.qkv.bias[cols])
        return y[:, 1:].reshape(y.shape[0], self.grid, self.grid, -1).permute(0, 3, 1, 2)
