"""DINOv2 and DINOv3 Vision Transformer trunks in PyTorch.

The blocks of DINOv2 (Oquab et al., arXiv:2304.07193; ViT-S/B/L/g at patch
14) and of DINOv3 (Siméoni et al., arXiv:2508.10104; ViT-7B at patch 16),
run to one block's facet or to the final norm and returned as a patch grid,
for use as ``DeepConvFeature(module=ViTTrunk(...))``. This is how AnyLoc
(Keetha et al., arXiv:2308.00688) takes its local features: the value facet
of ViT-g/14's block 31, with the CLS token dropped.

A forward takes ``(B, 3, H, W)`` (channels-last strides accepted) and runs,
with DINOv2's and DINOv3's names:

- ``patch_embed.proj``, a ``p x p`` conv at stride ``p`` (the spec's
  ``patch``), to ``gh x gw`` patch tokens; ``cls_token`` in front. With
  learned positions (DINOv2) ``pos_embed`` (fixed grid, no interpolation)
  is added, and only the trunk's ``image_size`` is taken. With RoPE
  (DINOv3) the spec's ``registers`` tokens (``storage_tokens``) follow the
  CLS token, nothing is added, and any sides that are multiples of ``p``
  are taken: the grid follows the input;
- blocks ``0 .. layer-1``, each pre-norm with LayerScale on both branches:
  ``x + ls1.gamma * attn(norm1(x))``, then ``x + ls2.gamma * mlp(norm2(x))``
  (LayerNorm eps the spec's ``ln_eps``, 1e-6 in DINOv2, 1e-5 in DINOv3;
  biases on ``attn.proj`` and the FFN, on ``attn.qkv`` where ``qkv_bias``);
  the FFN is GELU (``mlp.fc1``, ``mlp.fc2``) or SwiGLU (``mlp.w12`` to two
  halves, ``silu(x1) * x2``, ``mlp.w3``; DINOv3's ``mlp.w1`` and
  ``mlp.w2`` stacked are ``mlp.w12``);
- the facet: ``"query"``, ``"key"`` or ``"value"`` is that third of
  ``attn.qkv`` applied to ``norm1`` of block ``layer``'s input (the rest of
  the block is not run; learned positions only); ``"token"`` is block
  ``layer``'s output; ``"norm"`` is every block, then ``norm``, the final
  LayerNorm (DINOv3's ``x_norm_patchtokens``);
- the CLS and register rows dropped, ``(B, C, gh, gw)`` returned.

RoPE (DINOv3's ``RopePositionEmbedding`` at inference, ``apply_rope``):
with ``hd`` the head width and ``g`` a side of the grid, patch ``i`` has
the centre ``c = 2 (i + 0.5) / g - 1`` on each axis; ``periods = 100 **
(2 k / (hd / 2))`` for ``k < hd / 4`` (base :data:`ROPE_BASE`); ``angles = 2 pi c / periods``, the
y angles then the x angles (``hd / 2`` of them), tiled twice to ``hd``;
``q' = q cos + rotate_half(q) sin`` with ``rotate_half(x) = [-x2, x1]``
over the two halves of each head, and likewise ``k'``; the CLS and
register rows are not rotated. The table (:func:`rope_table`) holds the
``hd / 2`` distinct angles' cos and sin in float32, so a head's halves
become ``x1 cos - x2 sin`` and ``x2 cos + x1 sin``; it is made once per
grid and device and kept. The rotation runs in float32 and rounds q and
k once to their dtype, as the DINOv3 repository's ``apply_rope`` with its
float32 RoPE does (Hugging Face's port rounds cos and sin to the model's
dtype first). It rotates ``qkv``'s output in place, between ``attn.qkv``
and the attention core (:meth:`Attention.rotate`).

The trunk holds blocks ``0 .. layer`` only (and ``norm`` for the norm
facet), so a state dict cut to those blocks loads as it is.

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
whose width is a multiple of 8 run hand-written kernels, SwiGLU in one
pass over ``w12``'s output, each LayerScale + residual add together with
the LayerNorm that follows it (``ls1`` with ``norm2``, ``ls2`` with the
next block's ``norm1``, or with ``norm`` after the last block; the trunk
hands the normed map on, so only block 0's ``norm1`` is a LayerNorm of
its own), and the RoPE rotation in one in-place pass over ``qkv``'s q and
k thirds (half-heads a multiple of 8 columns); anything else runs their
plain versions, the torch passes ``F.silu(x1) * x2``, ``torch.addcmul``,
``F.layer_norm`` and the rotation's float32 products. A block called alone
(:meth:`Block.forward`) takes the same passes and ends with its ``ls2``
add.

Under ``profiling.record()`` the trunk opens the spans ``vit.embed``,
``vit.blocks`` (and in each block ``vit.attention`` and ``vit.ffn``) and
``vit.facet``, or ``vit.norm`` for the norm facet (the last block, whose
closing add takes the final LayerNorm in the same pass, and the patch
rows), and counts ``attn.<route>`` (one a block's attention call),
``vit.swiglu.<route>``, ``vit.add_norm.<route>`` and ``vit.rope.<route>``
(one a pass, route ``kernel`` or ``plain``; ``vit.rope`` one a block under
RoPE) and ``vit.tokens`` (the tokens a forward carries through the
blocks).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..ops.cuda import vit_passes

__all__ = ["ViTTrunk", "ViTSpec", "VARIANTS", "FACETS", "attention_route", "attention_reference",
           "rope_table"]

FACETS = ("query", "key", "value", "token", "norm")
POSITIONS = ("learned", "rope")
ROPE_BASE = 100.0  # DINOv3's, in every variant
FUSED_ROUTE = "cudnn"


@dataclass(frozen=True)
class ViTSpec:
    """The widths of a ViT: ``ffn`` is ``"mlp"`` (GELU) or ``"swiglu"``,
    ``ffn_hidden`` the width between the FFN's two linears; ``patch`` the
    patch side, ``registers`` the register tokens after CLS (RoPE only),
    ``position`` ``"learned"`` (an absolute embedding) or ``"rope"``
    (DINOv3's 2-D RoPE), ``ln_eps`` the LayerNorms' eps, and ``qkv_bias``
    whether ``attn.qkv`` has a bias."""

    embed_dim: int
    depth: int
    num_heads: int
    ffn: str
    ffn_hidden: int
    patch: int = 14
    registers: int = 0
    position: str = "learned"
    ln_eps: float = 1e-6
    qkv_bias: bool = True


# DINOv2's published variants (its hub models, patch 14, 518^2 position grid).
# ViT-g's SwiGLUFFNFused: (int(4 * 1536 * 2 / 3) + 7) // 8 * 8 = 4,096.
# DINOv3's ViT-7B (its hub's dinov3_vit7b16): swiglu64 of ffn_ratio 3,
# int(3 * 4096 * 2 / 3) = 8,192; 4 storage tokens; no qkv bias.
VARIANTS = {
    "dinov2_vits14": ViTSpec(384, 12, 6, "mlp", 1536),
    "dinov2_vitb14": ViTSpec(768, 12, 12, "mlp", 3072),
    "dinov2_vitl14": ViTSpec(1024, 24, 16, "mlp", 4096),
    "dinov2_vitg14": ViTSpec(1536, 40, 24, "swiglu", 4096),
    "dinov3_vit7b16": ViTSpec(4096, 40, 32, "swiglu", 8192, patch=16, registers=4,
                              position="rope", ln_eps=1e-5, qkv_bias=False),
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


def rope_table(gh: int, gw: int, head_dim: int, base: float = ROPE_BASE,
               device=None) -> torch.Tensor:
    """DINOv3's RoPE for a ``gh x gw`` patch grid (row-major) and heads of
    ``head_dim``: ``(2, gh * gw, head_dim / 2)`` float32, the cos then the
    sin of each patch's y angles then x angles (see the module docstring)."""
    dd = {"device": device, "dtype": torch.float32}
    periods = base ** (2 * torch.arange(head_dim // 4, **dd) / (head_dim // 2))
    ys = torch.arange(0.5, gh, **dd) / gh
    xs = torch.arange(0.5, gw, **dd) / gw
    coords = 2.0 * torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).flatten(0, 1) - 1.0
    angles = (2 * math.pi * coords[:, :, None] / periods).flatten(1)
    return torch.stack([angles.cos(), angles.sin()])


class LayerScale(nn.Module):
    """DINOv2's ``ls1`` / ``ls2``: ``gamma``, which :class:`Block` applies
    together with the residual add."""

    def __init__(self, dim: int, **factory):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, **factory))


def _route(x: torch.Tensor, width: int) -> str:
    return "kernel" if vit_passes.takes(x, width) else "plain"


class Attention(nn.Module):
    """Multi-head self-attention with DINOv2's ``qkv`` (q, k, v thirds, each
    head's columns together) and ``proj``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, **factory):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, **factory)
        self.proj = nn.Linear(dim, dim, **factory)

    def forward(self, x: torch.Tensor, rope: torch.Tensor | None = None) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x)
        if rope is not None:
            qkv = self.rotate(qkv, rope)
        qkv = qkv.view(b, n, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4)
        o = self.core(qkv[0], qkv[1], qkv[2])
        return self.proj(o.transpose(1, 2).reshape(b, n, c))

    def rotate(self, qkv: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
        """``qkv`` ``(B, N, 3C)`` with the q and k of its last ``P`` rows an
        image rotated in place by the table ``rope`` ``(2, P, hd / 2)``
        (:func:`rope_table`), by the route the trunk takes; returns ``qkv``."""
        route = _route(qkv, rope.shape[-1])
        profiling.count(f"vit.rope.{route}", 1)
        fn = vit_passes.rope if route == "kernel" else vit_passes.rope_reference
        return fn(qkv, rope)

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
        self.norm1 = nn.LayerNorm(dim, eps=spec.ln_eps, **factory)
        self.attn = Attention(dim, spec.num_heads, spec.qkv_bias, **factory)
        self.ls1 = LayerScale(dim, **factory)
        self.norm2 = nn.LayerNorm(dim, eps=spec.ln_eps, **factory)
        ffn = SwiGLUFFN if spec.ffn == "swiglu" else Mlp
        self.mlp = ffn(dim, spec.ffn_hidden, **factory)
        self.ls2 = LayerScale(dim, **factory)

    def forward(self, x: torch.Tensor, rope: torch.Tensor | None = None) -> torch.Tensor:
        return self.run(x, self.norm1(x), rope=rope)[0]

    def run(self, x: torch.Tensor, h: torch.Tensor, next_norm: nn.LayerNorm | None = None,
            rope: torch.Tensor | None = None):
        """The block on ``x`` and ``h = norm1(x)`` (RoPE table ``rope``, or
        none): ``(out, next_norm(out))``, or ``(out, None)`` without
        ``next_norm``."""
        with profiling.span("vit.attention"):
            x, h = add_norm(x, self.attn(h, rope), self.ls1, self.norm2)
        with profiling.span("vit.ffn"):
            y = self.mlp(h)
            if next_norm is None:
                # LayerScale and the residual add in one pass, one rounding.
                return torch.addcmul(x, y, self.ls2.gamma), None
            return add_norm(x, y, self.ls2, next_norm)


class ViTTrunk(nn.Module):
    """A DINOv2 or DINOv3 ViT run to one block's facet or to its final norm:
    ``(B, 3, H, W) -> (B, C, H/p, W/p)`` (see the module docstring).

    :param variant: a name of :data:`VARIANTS` or a :class:`ViTSpec`.
    :param layer: the block whose facet is returned (negative from the end
        of ``depth``; default the last, which the ``"norm"`` facet needs).
    :param facet: ``"value"``, ``"key"``, ``"query"`` (learned positions
        only), ``"token"`` or ``"norm"``.
    :param image_size: the input side, a multiple of the patch. With learned
        positions it fixes the position grid (DINOv2's is 518, 37 x 37) and
        is the only size taken; with RoPE it is the size the extractor
        resizes to, and the trunk takes any multiple of the patch.
    :param device, dtype: where and in what the parameters are made.

    The parameters start at DINOv2's initialisation (truncated normal
    linears, patch projection and position embedding, std 0.02; zero
    biases; unit LayerNorms; LayerScale 1e-5; CLS and register tokens
    N(0, 1e-6)), drawn from seed 0.
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
        if variant.position not in POSITIONS:
            raise ValueError(f"position must be one of {POSITIONS}, got {variant.position!r}")
        rope = variant.position == "rope"
        if facet == "norm" and layer % variant.depth != variant.depth - 1:
            raise ValueError(f"the norm facet follows the last block; got layer {layer}")
        if rope and facet in ("query", "key"):
            raise ValueError(f"the {facet} facet is taken with learned positions only")
        if variant.registers and not rope:
            raise ValueError("register tokens are taken with RoPE positions only")
        if rope and (variant.embed_dim // variant.num_heads) % 4:
            raise ValueError("RoPE needs a head width that is a multiple of 4")
        p = variant.patch
        if image_size % p:
            raise ValueError(f"image_size must be a multiple of {p}, got {image_size}")
        self.spec, self.facet, self.image_size = variant, facet, image_size
        self.layer = layer % variant.depth
        self.grid = image_size // p
        self.prefix = 1 + variant.registers
        factory = {"device": device, "dtype": dtype}
        dim = variant.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, p, p, **factory)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **factory))
        self.storage_tokens = (nn.Parameter(torch.empty(1, variant.registers, dim, **factory))
                               if variant.registers else None)
        self.pos_embed = (None if rope else
                          nn.Parameter(torch.empty(1, 1 + self.grid ** 2, dim, **factory)))
        self.blocks = nn.ModuleList(Block(variant, **factory) for _ in range(self.layer + 1))
        self.norm = (nn.LayerNorm(dim, eps=variant.ln_eps, **factory) if facet == "norm"
                     else None)
        self._rope_tables: dict = {}
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
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(1e-5)
        if self.pos_embed is not None:
            draw(self.pos_embed, 0.02)
        draw(self.cls_token, 1e-6, truncated=False)
        if self.storage_tokens is not None:
            draw(self.storage_tokens, 1e-6, truncated=False)

    def _grid(self, h: int, w: int) -> tuple[int, int]:
        p = self.spec.patch
        if self.pos_embed is not None:
            if (h, w) != (self.image_size, self.image_size):
                raise ValueError(f"ViTTrunk takes {self.image_size}^2 images (its position "
                                 f"grid), got {h}x{w}")
        elif h % p or w % p:
            raise ValueError(f"ViTTrunk takes sides that are multiples of {p}, got {h}x{w}")
        return h // p, w // p

    def rope(self, gh: int, gw: int, device) -> torch.Tensor:
        """The RoPE table of a ``gh x gw`` grid on ``device``, made once and
        kept (outside inference mode, so that any later call may use it)."""
        key = (gh, gw, torch.device(device))
        table = self._rope_tables.get(key)
        if table is None:
            hd = self.spec.embed_dim // self.spec.num_heads
            with torch.inference_mode(False):
                table = rope_table(gh, gw, hd, ROPE_BASE, device)
            self._rope_tables[key] = table
        return table

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        gh, gw = self._grid(h, w)
        with profiling.span("vit.embed"):
            t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            if self.pos_embed is not None:
                t = torch.cat([self.cls_token.expand(b, -1, -1), t], dim=1) + self.pos_embed
                rope = None
            else:
                prefix = [self.cls_token.expand(b, -1, -1)]
                if self.storage_tokens is not None:
                    prefix.append(self.storage_tokens.expand(b, -1, -1))
                t = torch.cat([*prefix, t], dim=1)
                rope = self.rope(gh, gw, x.device)
        profiling.count("vit.tokens", t.shape[0] * t.shape[1])
        blocks = self.blocks
        with profiling.span("vit.blocks"):
            h = blocks[0].norm1(t)
            for i in range(self.layer):
                t, h = blocks[i].run(t, h, blocks[i + 1].norm1, rope)
        with profiling.span("vit.norm" if self.facet == "norm" else "vit.facet"):
            y = self._facet(t, h, rope)
        return y[:, self.prefix:].reshape(b, gh, gw, -1).permute(0, 3, 1, 2)

    def _facet(self, t: torch.Tensor, h: torch.Tensor, rope) -> torch.Tensor:
        """Block ``layer``'s facet of every token, from its input ``t`` and
        ``h = norm1(t)``. A ``qkv`` third runs over every token, the prefix
        rows dropped after it (LayerNorm and the linear act token by token),
        so no strided copy of the patch rows is made; the norm facet is the
        last block's closing add with ``norm`` in the same pass."""
        blk = self.blocks[self.layer]
        if self.facet == "norm":
            return blk.run(t, h, self.norm, rope)[1]
        if self.facet == "token":
            return blk.run(t, h, rope=rope)[0]
        d, j = self.spec.embed_dim, FACETS.index(self.facet)
        cols = slice(j * d, (j + 1) * d)
        bias = blk.attn.qkv.bias
        return F.linear(h, blk.attn.qkv.weight[cols], None if bias is None else bias[cols])
